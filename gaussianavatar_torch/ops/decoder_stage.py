"""The fused POP decoder stage (models/decoder.ShapeDecoderFused): its three
CUDA kernels, each beside its plain PyTorch version, and the autograd
Functions that tie them together.

A stage is Dense -> BatchNorm -> activation with the BatchNorm folded into
the Dense (the JAX package's `ShapeDecoderFused`,
gaussianavatar_tpu/models/decoder.py:199-222). The JAX package has no
Pallas kernel for it (XLA fuses it on the TPU); here three hand-written
kernels keep the (R, H) pre-activation out of device memory, at every width
the JAX decoder takes (any input width C and hsize H):

  - H-dstat (`column_stats`, csrc/decoder_stats.cu): one pass over the
    stage's input x (R, C) -> the column sums (C,) and the Gram x^T x
    (C, C), both accumulated in float32 (only the Gram's upper triangle is
    computed), by a deterministic two-pass reduction. The batch statistics
    of the pre-activation follow from them and the weights alone.
  - H-dfwd (`stage_fwd`, csrc/decoder_stage_fwd.cu): z = act(x Wp + bp)
    with the folded weights Wp (C, H) and bias bp (H,), any C and H; the
    product accumulates in float32, the bias and the activation run in its
    epilogue, and only z is written.

Both run their products on the tensor cores (wgmma): bfloat16 products
exactly, float32 ones as 3xTF32 (`tf32_split`: each operand a = hi + lo in
tf32, a b = hi hi + hi lo + lo hi, float32 to about 2^-22 of each term),
never as one TF32 product, which keeps about 3 decimal digits.
  - H-dbwd (`stage_bwd`, csrc/decoder_stage_bwd.cu): du = g * act'(u)
    rebuilt from z alone (softplus: sigma(u) = 1 - exp(-z); relu: z > 0)
    and, in the same pass, the bias gradient sum_rows du in float32, by a
    deterministic two-pass reduction.

Each wrapper launches its kernel for a CUDA tensor, and only a CPU tensor
takes the plain version; a kernel that cannot be built or launched raises.
Each launch adds one to `cuda_build.LAUNCHES[<kernel>]`. Rounding follows
the JAX stage on the CPU: in bfloat16 the product accumulates in float32
and is rounded to bfloat16, and the bias add and each operation of the
activation round to bfloat16 (the plain versions do the same).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

ACTIVATIONS = ("softplus", "relu")

# H-dbwd splits the rows into about this many blocks (132 SMs, 8 blocks
# each), each writing its partial sums for the second pass
_TARGET_BLOCKS = 1056


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's formula, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), so the f32 decoder matches the JAX one to the ulp."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _act(act: str, u: torch.Tensor) -> torch.Tensor:
    return torch.relu(u) if act == "relu" else softplus(u)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo), float32 tensors of tf32 values (10 explicit
    mantissa bits), x = hi + lo to 2^-22 of |x|: the split the float32 forms
    of H-dfwd and H-dstat make of each operand (csrc/decoder_common.cuh
    `tf32_split`). hi rounds x to nearest, ties away from zero, on the int32
    view, as cvt.rna.tf32.f32 does (a NaN stays a NaN); lo rounds x - hi
    (exact in float32) the same way. Where hi is not finite (inf, NaN, or a
    value that rounds past the largest float) lo is 0."""
    def rna(v):
        r = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(v), v, r)

    hi = rna(x)
    lo = torch.where(torch.isfinite(hi), rna(x - hi), torch.zeros_like(x))
    return hi, lo


def _check(fn, name, t, dtypes, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{fn}: {name} must be one of {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _check_act(fn, act):
    if act not in ACTIVATIONS:
        raise ValueError(f"{fn}: act must be one of {ACTIVATIONS}, got {act!r}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(R: int) -> Tuple[int, int]:
    """(splits, rows per split) of R rows: about _TARGET_BLOCKS blocks in
    all, at least one row each."""
    rows = max(1, _cdiv(R, max(1, min(_TARGET_BLOCKS, R))))
    return max(1, _cdiv(R, rows)), rows


def _call(name: str, fn_name: str, argtypes, *args) -> int:
    """Calls the kernel library's C function -> its return code."""
    from gaussianavatar_torch.utils.cuda_build import load_library

    fn = getattr(load_library(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn(*args)


def _launch(name: str, fn_name: str, argtypes, *args):
    """Calls the kernel library's launching C function; raises on a CUDA
    error."""
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES

    rc = _call(name, fn_name, argtypes, *args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# H-dstat: column sums and Gram
# --------------------------------------------------------------------------

def column_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) float32 or bfloat16 -> (column sums (C,), x^T x (C, C)),
    summed in float64 and rounded to float32: the sums a float32
    accumulation approaches, whatever its order."""
    xd = x.double()
    return xd.sum(0).float(), (xd.t() @ xd).float()


def column_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """As `column_stats_plain`. A CUDA tensor launches H-dstat (built from
    csrc/decoder_stats.cu on first use) on the current stream, with its
    row splits planned for the device's SM count; float32 input's products
    run as 3xTF32 (`tf32_split`)."""
    if x.device.type == "cpu":
        return column_stats_plain(x)
    from gaussianavatar_torch.utils.cuda_build import load_library

    load_library("decoder_stats")
    _check("column_stats", "x", x, (torch.float32, torch.bfloat16))
    if x.dim() != 2:
        raise ValueError(f"column_stats: x must be (rows, columns), got {tuple(x.shape)}")
    R, C = x.shape
    p, i = ctypes.c_void_p, ctypes.c_int
    bf16 = int(x.dtype == torch.bfloat16)
    n_split = ctypes.c_int()
    if _call("decoder_stats", "ga_decoder_stats_plan", [i, i, i, i, ctypes.POINTER(i)], bf16,
             R, C, _sm_count(x.device.index or 0), ctypes.byref(n_split)):
        raise ValueError(f"column_stats: cannot plan {tuple(x.shape)}")
    n_split = n_split.value
    colsum = torch.empty(C, dtype=torch.float32, device=x.device)
    gram = torch.empty((C, C), dtype=torch.float32, device=x.device)
    work = torch.empty((n_split, C * C + C), dtype=torch.float32, device=x.device)
    _launch("decoder_stats", "ga_decoder_stats", [p, i, i, i, i, p, p, p, p],
            x.data_ptr(), bf16, R, C, n_split,
            work.data_ptr(), colsum.data_ptr(), gram.data_ptr(), _stream(x))
    return colsum, gram


# --------------------------------------------------------------------------
# H-dfwd: z = act(x Wp + bp)
# --------------------------------------------------------------------------

def stage_fwd_plain(x: torch.Tensor, Wp: torch.Tensor, bp: torch.Tensor,
                    act: str) -> torch.Tensor:
    """x (R, C) float32 or bfloat16, Wp (C, H) and bp (H,) in the compute
    dtype -> z (R, H) in the compute dtype. float32: z = act(x Wp + bp).
    bfloat16: x is cast to bfloat16, the product accumulated in float32
    and rounded to bfloat16, then the bias added and the activation
    computed in bfloat16, rounded after every operation (softplus: exp,
    log1p and the sum each rounded), as the JAX stage does on the CPU."""
    cdt = Wp.dtype
    if cdt == torch.float32:
        return _act(act, x.float() @ Wp + bp)
    u = (x.to(cdt).float() @ Wp.float()).to(cdt)
    return _act(act, u + bp)


def stage_fwd(x: torch.Tensor, Wp: torch.Tensor, bp: torch.Tensor, act: str) -> torch.Tensor:
    """As `stage_fwd_plain`. A CUDA tensor launches H-dfwd (built from
    csrc/decoder_stage_fwd.cu on first use) on the current stream: bfloat16
    products on the tensor cores (wgmma), float32 ones there as 3xTF32
    (`tf32_split`); any C and H."""
    if x.device.type == "cpu":
        return stage_fwd_plain(x, Wp, bp, act)
    from gaussianavatar_torch.utils.cuda_build import load_library

    load_library("decoder_stage_fwd")
    fn = "stage_fwd"
    _check_act(fn, act)
    cdt = Wp.dtype
    _check(fn, "Wp", Wp, (torch.float32, torch.bfloat16))
    _check(fn, "x", x, (torch.float32,) if cdt == torch.float32 else
           (torch.float32, torch.bfloat16))
    if x.dim() != 2 or Wp.dim() != 2 or Wp.shape[0] != x.shape[1]:
        raise ValueError(f"{fn}: x (R, C) and Wp (C, H) needed, got {tuple(x.shape)} and "
                         f"{tuple(Wp.shape)}")
    R, C = x.shape
    H = Wp.shape[1]
    _check(fn, "bp", bp, (cdt,), (H,))
    z = torch.empty((R, H), dtype=cdt, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    _launch("decoder_stage_fwd", "ga_decoder_stage_fwd", [p, i, p, p, i, i, i, i, i, p, p],
            x.data_ptr(), int(x.dtype == torch.bfloat16), Wp.data_ptr(), bp.data_ptr(),
            int(cdt == torch.bfloat16), int(act == "relu"), R, C, H, z.data_ptr(), _stream(x))
    return z


# --------------------------------------------------------------------------
# H-dbwd: du = g * act'(u) from z, and sum_rows du
# --------------------------------------------------------------------------

def stage_bwd_plain(g: torch.Tensor, z: torch.Tensor,
                    act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """g, z (R, H) -> (du (R, H) in their dtype, du's column sums (H,)
    float32). softplus: du = g (1 - exp(-z)) in float32, rounded; relu:
    du = g where z > 0, else 0 (the JAX stage's output-side backward)."""
    if act == "relu":
        du = torch.where(z > 0, g, torch.zeros_like(g))
    else:
        du = (g.float() * (1.0 - torch.exp(-z.float()))).to(g.dtype)
    return du, du.float().sum(0)


def stage_bwd(g: torch.Tensor, z: torch.Tensor, act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """As `stage_bwd_plain`. A CUDA tensor launches H-dbwd (built from
    csrc/decoder_stage_bwd.cu on first use) on the current stream; any
    width."""
    if g.device.type == "cpu":
        return stage_bwd_plain(g, z, act)
    from gaussianavatar_torch.utils.cuda_build import load_library

    load_library("decoder_stage_bwd")
    fn = "stage_bwd"
    _check_act(fn, act)
    _check(fn, "z", z, (torch.float32, torch.bfloat16))
    _check(fn, "g", g, (z.dtype,), tuple(z.shape))
    if z.dim() != 2:
        raise ValueError(f"{fn}: z must be (rows, columns), got {tuple(z.shape)}")
    R, H = z.shape
    n_split, rows = _split(R)
    du = torch.empty_like(z)
    dbp = torch.empty(H, dtype=torch.float32, device=z.device)
    work = torch.empty((n_split, H), dtype=torch.float32, device=z.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    _launch("decoder_stage_bwd", "ga_decoder_stage_bwd", [p, p, i, i, i, i, i, i, p, p, p, p],
            g.data_ptr(), z.data_ptr(), int(z.dtype == torch.bfloat16), int(act == "relu"),
            R, H, n_split, rows, work.data_ptr(), du.data_ptr(), dbp.data_ptr(), _stream(z))
    return du, dbp


# --------------------------------------------------------------------------
# The autograd Functions of a fused stage
# --------------------------------------------------------------------------

class ColumnStats(torch.autograd.Function):
    """x (R, C) -> (column sums, x^T x) through H-dstat; the backward,
    d x = x (dG + dG^T) + dsum, is a float32 product cast to x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return column_stats(x)

    @staticmethod
    def backward(ctx, dsum, dgram):
        x, = ctx.saved_tensors
        return ((x.float() @ (dgram + dgram.t())) + dsum).to(x.dtype)


class FusedStage(torch.autograd.Function):
    """z = act(x Wp + bp) through H-dfwd, saving x, Wp and z (never the
    pre-activation). The backward: H-dbwd gives du and d bp, then
    d x = du Wp^T and d Wp = x^T du are products in the compute dtype
    (float32 accumulation), as the JAX stage's transposed matmuls."""

    @staticmethod
    def forward(ctx, x, Wp, bp, act):
        z = stage_fwd(x, Wp, bp, act)
        ctx.act = act
        ctx.save_for_backward(x, Wp, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, Wp, z = ctx.saved_tensors
        du, dbp = stage_bwd(g.contiguous(), z, ctx.act)
        dx = (du @ Wp.t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        dWp = x.to(du.dtype).t() @ du if ctx.needs_input_grad[1] else None
        return dx, dWp, dbp.to(Wp.dtype), None
