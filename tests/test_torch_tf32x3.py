"""3xTF32, the float32 products of the fused decoder's kernels (H-dfwd and
H-dstat, csrc/decoder_stage_fwd.cu and decoder_stats.cu), emulated on the CPU.

Each float32 operand is split as a = hi + lo in tf32 (`ops/decoder_stage.
tf32_split`, the plain twin of the kernels' split), and a product is taken
as hi hi + hi lo + lo hi: TF32 products are exact and sum in float32, so
the emulation runs them as float32 matmuls of the parts, in the order the
kernels sum them. The stage's output and the Gram are held against float64
at every width the decoder takes; the kernels themselves are held against
their plain versions on the card (tests/test_torch_rules.py -m gpu,
chip_smoke.py phase 11)."""

import numpy as np
import pytest
import torch

from gaussianavatar_torch.ops import decoder_stage as ds

TOL_DFWD_F32 = 1e-5   # H-dfwd's float32 hold on the card, of max|z|


def _bits(t):
    return t.view(torch.int32)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi is x rounded to 10 explicit mantissa bits, to nearest, ties away
    from zero (cvt.rna), and lo is the rest rounded the same way."""
    one = 1.0
    x = torch.tensor([one, one + 2.0**-11, one + 3 * 2.0**-11, one + 2.0**-11 + 2.0**-20,
                      one + 2.0**-11 - 2.0**-20, -(one + 2.0**-11), 2.0 - 2.0**-12],
                     dtype=torch.float32)
    hi, lo = ds.tf32_split(x)
    want_hi = [one, one + 2.0**-10, one + 2 * 2.0**-10, one + 2.0**-10, one,
               -(one + 2.0**-10), 2.0]
    assert hi.tolist() == want_hi
    assert (hi.double() + lo.double()).tolist() == x.double().tolist()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e35])
def test_tf32_split_exact(scale):
    """hi has 10 explicit mantissa bits, hi + lo recovers x to 2^-22 of |x|
    (for |x| whose lo stays a normal float, above about 2^-104), hi keeps
    x's sign and lo is tf32 too."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal(20000) * scale, dtype=torch.float32)
    hi, lo = ds.tf32_split(x)
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    assert bool(((_bits(lo) & 0x1FFF) == 0).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    assert bool((torch.sign(hi) == torch.sign(x)).all())
    # lo is the remainder: at most half a tf32 ulp of x
    assert bool((lo.double().abs() <= 2.0**-11 * x.double().abs()).all())


def test_tf32_split_zeros_and_specials():
    """Zeros keep their sign in hi and split to lo 0; inf and NaN stay in
    hi with lo 0, as the kernels' split keeps them; a value that rounds past
    the largest float becomes inf with lo 0."""
    fmax = torch.finfo(torch.float32).max
    x = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), fmax, -fmax],
                     dtype=torch.float32)
    hi, lo = ds.tf32_split(x)
    assert _bits(hi)[:2].tolist() == _bits(x)[:2].tolist()
    assert hi[2:4].tolist() == [float("inf"), float("-inf")]
    assert bool(torch.isnan(hi[4]))
    assert hi[5:].tolist() == [float("inf"), float("-inf")]
    assert lo.tolist() == [0.0] * 7


def _stage_inputs(C, H, R, seed):
    """A stage's input (the first stage's features, else positive
    activations), folded weights and bias, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, C))
    if C not in (65, 66):
        x = np.log1p(np.exp(x))
    W = rng.standard_normal((C, H)) / np.sqrt(C)
    b = 0.1 * rng.standard_normal(H)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    return f(x), f(W), f(b)


def _act(act, u):
    return torch.relu(u) if act == "relu" else ds.softplus(u)


def _stage_3xtf32(x, Wp, bp, act):
    """H-dfwd's float32 mode: lo hi + hi lo in one sum, hi hi in another,
    then their sum, the bias and the activation in float32."""
    xh, xl = ds.tf32_split(x)
    wh, wl = ds.tf32_split(Wp)
    small = xl @ wh + xh @ wl
    big = xh @ wh
    return _act(act, big + small + bp)


# the stage inputs the decoder takes (66 and 65 at c_geom 64 and 63, H, the
# skip stage's 66 + H and 65 + H) against the hsizes of the chip's holds
WIDTHS_C = (65, 66, 128, 193, 194, 322)
WIDTHS_H = (64, 96, 128, 256)


@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("H", WIDTHS_H)
@pytest.mark.parametrize("C", WIDTHS_C)
def test_3xtf32_stage_matches_float64(C, H, act):
    """z = act(x Wp + bp) as 3xTF32 stays within a tenth of H-dfwd's float32
    hold (1e-6 of max|z|) of the float64 stage; one TF32 product alone
    misses the hold itself."""
    x, Wp, bp = _stage_inputs(C, H, 384, seed=C + 1000 * H)
    z64 = _act(act, x.double() @ Wp.double() + bp.double())
    big = float(z64.abs().max())
    z = _stage_3xtf32(x, Wp, bp, act)
    assert float((z.double() - z64).abs().max()) <= 0.1 * TOL_DFWD_F32 * big
    single = _act(act, ds.tf32_split(x)[0] @ ds.tf32_split(Wp)[0] + bp)
    assert float((single.double() - z64).abs().max()) > TOL_DFWD_F32 * big


def _gram_slabs(x, slab, n_split, tf32):
    """H-dstat's order: split s takes slabs s, s + n_split, ...; each slab's
    Gram (3xTF32, or true float32 products) and column sums from zero, added
    to the split's float32 totals, then the splits added in order."""
    R, C = x.shape
    n_slabs = -(-R // slab)
    colsum, gram = torch.zeros(C), torch.zeros(C, C)
    for s in range(n_split):
        cs, g = torch.zeros(C), torch.zeros(C, C)
        for k in range(s, n_slabs, n_split):
            xs = x[k * slab:(k + 1) * slab]
            if tf32:
                h, lo = ds.tf32_split(xs)
                g += (lo.t() @ h + h.t() @ lo) + h.t() @ h
            else:
                g += xs.t() @ xs
            cs += xs.sum(0)
        colsum += cs
        gram += g
    return colsum, gram


def _variance(colsum, gram, n, W, b):
    """The batch variance of x W + b from the statistics, as
    models/decoder.ShapeDecoderFused._fused computes it (float32)."""
    m, S = colsum / n, gram / n
    mw = m @ W
    mu = mw + b
    e2 = (W * (S @ W)).sum(0) + 2.0 * b * mw + b * b
    return torch.maximum(e2 - mu * mu, torch.zeros_like(mu))


# (C, H, rows a slab as the kernel takes them at that width)
GRAM_CASES = [(65, 128, 64), (66, 128, 64), (128, 128, 64), (193, 128, 32), (194, 128, 32),
              (322, 256, 32)]


@pytest.mark.parametrize("C,H,slab", GRAM_CASES, ids=[f"c{c}" for c, _, _ in GRAM_CASES])
def test_3xtf32_gram_and_variance(C, H, slab):
    """H-dstat's float32 form emulated in its summation order: the Gram and
    the column sums within 1e-6 of their largest entry of float64's, and the
    BatchNorm variance the decoder takes from them (e2 - mu^2, which
    cancels) within 2.5x the distance from float64 of the same statistics
    summed from true float32 products (what an FFMA kernel gives)."""
    R = 4096
    x, W, b = _stage_inputs(C, H, R, seed=7 * C)
    x64 = x.double()
    colsum, gram = _gram_slabs(x, slab, 16, tf32=True)
    g64, s64 = x64.t() @ x64, x64.sum(0)
    assert float((gram.double() - g64).abs().max()) <= 1e-6 * float(g64.abs().max())
    assert float((colsum.double() - s64).abs().max()) <= 1e-6 * float(s64.abs().max())

    var64 = (x64 @ W.double() + b.double()).var(0, unbiased=False)
    v3 = float((_variance(colsum, gram, R, W, b).double() - var64).abs().max())
    cs_f, gram_f = _gram_slabs(x, slab, 16, tf32=False)
    vf = float((_variance(cs_f, gram_f, R, W, b).double() - var64).abs().max())
    assert v3 <= 2.5 * vf
