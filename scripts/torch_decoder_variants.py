"""Where the float32 forms of H-dstat and H-dfwd spend their time, on the
card: builds variants of csrc/decoder_stats.cu and csrc/decoder_stage_fwd.cu
with one part of the work taken out (a copy of each source with a
preprocessor switch around that part), and times each variant against the
unchanged kernel on the same float32 inputs at the decoder's stage widths
(445,568 rows). The variants compute wrong results; only their times are
read.

  H-dstat: base; no products (the wgmma); no transpose (x^T stays as the
           last slab left it); neither (the ring, barriers and partials).
  H-dfwd:  base; no products (the A loads and splits stay); no epilogue
           (z = the sum); neither.

    python3 scripts/torch_decoder_variants.py

Needs a CUDA card and nvcc; writes only under build/decoder_variants/.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gaussianavatar_torch", "csrc")
OUT = os.path.join(REPO, "build", "decoder_variants")
ROWS = 445_568

# (anchor text in the source, text placed before it, text placed after it)
STATS_HOOKS = [
    ("    for (int c = c_first, rg = rg_first; rg < slab / 4;) {", "#ifndef NO_TRANSPOSE\n", ""),
    ("      if (c >= cr) {\n        c -= cr;\n        ++rg;\n      }\n    }", "", "\n#endif"),
    ("    if (has) {\n      wgmma_fence();", "#ifdef NO_PRODUCTS\n    if (false) {\n#else\n",
     ""),
]
FWD_HOOKS = [
    ("        mma_block_tf32<NB>(big, small, f[s], Bh, Bl, b + s, b + s == kb0);",
     "#ifndef NO_PRODUCTS\n", "\n#endif"),
    ("          v[e] = RELU ? fmaxf(u, 0.f) : softplus_f32(u);",
     "#ifdef NO_EPILOGUE\n          v[e] = u;\n#else\n", "\n#endif"),
]


def hooked(name, hooks):
    """The source with its hooks placed; raises where an anchor is gone."""
    src = open(os.path.join(CSRC, name)).read()
    for anchor, before, after in hooks:
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}: the anchor {anchor.splitlines()[0]!r} is not unique")
        if before.startswith("#ifdef NO_PRODUCTS"):   # replaces the anchor's first line
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, before + first + "\n#endif\n" + rest)
        else:
            src = src.replace(anchor, before + anchor + after)
    path = os.path.join(OUT, name)
    with open(path, "w") as f:
        f.write(src.replace('#include "decoder_common.cuh"',
                            f'#include "{os.path.join(CSRC, "decoder_common.cuh")}"'))
    return path


def build(item):
    from gaussianavatar_torch.utils.cuda_build import NVCC_FLAGS, nvcc_path

    label, src, flags = item
    lib = os.path.join(OUT, f"{label}.so")
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, *flags, "-o", lib, src], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {label}:\n{r.stderr[-4000:]}")
    return label, ctypes.CDLL(lib)


def time_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_decoder_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT, exist_ok=True)
    stats = hooked("decoder_stats.cu", STATS_HOOKS)
    fwd = hooked("decoder_stage_fwd.cu", FWD_HOOKS)
    variants = [("stats_base", stats, []), ("stats_no_products", stats, ["-DNO_PRODUCTS"]),
                ("stats_no_transpose", stats, ["-DNO_TRANSPOSE"]),
                ("stats_neither", stats, ["-DNO_PRODUCTS", "-DNO_TRANSPOSE"]),
                ("fwd_base", fwd, []), ("fwd_no_products", fwd, ["-DNO_PRODUCTS"]),
                ("fwd_no_epilogue", fwd, ["-DNO_EPILOGUE"]),
                ("fwd_neither", fwd, ["-DNO_PRODUCTS", "-DNO_EPILOGUE"])]
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(ex.map(build, variants))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    p, i = ctypes.c_void_p, ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for C, H in ((66, 128), (128, 128), (194, 128), (322, 256)):
        g = torch.Generator(device="cuda").manual_seed(C)
        x = torch.randn(ROWS, C, generator=g, device="cuda")
        W = torch.randn(C, H, generator=g, device="cuda") / C ** 0.5
        b = 0.1 * torch.randn(H, generator=g, device="cuda")
        z = torch.empty(ROWS, H, device="cuda")
        cs, gram = torch.empty(C, device="cuda"), torch.empty(C, C, device="cuda")
        line = []
        for label, lib in libs.items():
            if label.startswith("stats"):
                lib.ga_decoder_stats_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
                n = ctypes.c_int()
                lib.ga_decoder_stats_plan(0, ROWS, C, sms, ctypes.byref(n))
                work = torch.empty(n.value, C * C + C, device="cuda")
                lib.ga_decoder_stats.argtypes = [p, i, i, i, i, p, p, p, p]
                fn = (lambda lib=lib, work=work, n=n.value: lib.ga_decoder_stats(
                    x.data_ptr(), 0, ROWS, C, n, work.data_ptr(), cs.data_ptr(), gram.data_ptr(),
                    stream))
            else:
                lib.ga_decoder_stage_fwd.argtypes = [p, i, p, p, i, i, i, i, i, p, p]
                fn = (lambda lib=lib: lib.ga_decoder_stage_fwd(
                    x.data_ptr(), 0, W.data_ptr(), b.data_ptr(), 0, 0, ROWS, C, H, z.data_ptr(),
                    stream))
            if fn() != 0:
                raise SystemExit(f"{label} at {C} -> {H}: the launch failed")
            line.append(f"{label} {time_ms(fn):.4f}")
        print(f"{ROWS} rows, {C} -> {H}, float32 (ms): " + ", ".join(line) + f"; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
