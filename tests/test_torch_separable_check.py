"""The bf16 y check of ``chip_smoke.py`` [separable] (``compare_block``:
rtol 2^-7 of |plain| + atol 1e-5), the report of a miss (``y_misses``),
and the element of that check nearest its tolerance (ROADMAP C5).

The bf16 ``fold`` kernel sums k x Cin exact products per output element
in f32 on the tensor cores (``mma.sync`` m16n8k16: Cin chunks of 64, the
three taps, steps of 16), and the plain version sums the same products
in f32 by cuBLAS. Two such sums may round to neighbouring bf16 values:
at T=11, 512->512, batch 384, element [93, 2, 254], the card's kernel
gave 1.0 where the exact sum 1.00390692 rounds to 1.0078125, the plain
version's value. One bf16 step is at most 2^-7 of either value, so the
tolerance's rtol alone admits it (at 0.99 of the whole tolerance), as it
admits any one-step disagreement: that element cannot have been the
miss that ROADMAP C5 records. Here its products are rebuilt from the
block's inputs and summed in the kernel's order with each f32
accumulation truncated (as the tensor cores' may be), which lands on the
midpoint 1 + 2^-8 and rounds to the card's 1.0.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from speech_recognition_tpu_torch.export.benchmark import (
    separable_block_inputs,
)
from speech_recognition_tpu_torch.ops.kernels import separable_block as S

torch.set_num_threads(1)

BF16 = torch.bfloat16
# the element of chip_smoke's check nearest its tolerance, and both
# sides' values on the H100 (chip_smoke [separable], T=11 512->512
# s1 VALID fold bf16)
ELEMENT = (93, 2, 254)
CARD_KERNEL_Y, CARD_PLAIN_Y = 1.0, 1.0078125
CHUNK, MMA_K = 64, 16         # csrc/separable_block.cu: kChunk, m16n8k16
F32_U = 2.0 ** -24            # float32's unit roundoff


def _gamma(n: int, u: float) -> float:
    """Higham's gamma_n: the bound, relative to the sum of the terms'
    magnitudes, on the error of summing n terms in any order with unit
    roundoff u (2u where each addition truncates)."""
    return n * u / (1.0 - n * u)


def _truncate_f32(v: float) -> float:
    """``v`` rounded to f32 toward zero."""
    r = np.float32(v)
    if abs(float(r)) > abs(v):
        r = np.nextafter(r, np.float32(0))
    return float(r)


@pytest.fixture(scope="module")
def element():
    """The element's 3 x 512 products (float64, each exact), the plain
    version's y there, and its ``sum_terms``."""
    x, w_dw, w_pw, a, b = separable_block_inputs(11, 512, 512, dtype=BF16)
    bi, ti, ci = ELEMENT
    xin = torch.clamp(x[bi:bi + 1] * S._in_compute(a, BF16)
                      + S._in_compute(b, BF16), 0, 6)
    taps = S._taps(xin, 3, 1, 0, 9)
    w = S.fold_weights_of(w_dw, w_pw, BF16)
    terms = torch.stack([taps[i][0, ti].double() * w[i][:, ci].double()
                         for i in range(3)])                  # [3, Cin]
    ins = (x[bi:bi + 1], w_dw, w_pw, a, b)
    y = S.separable_block_plain(*ins, emit_stats=False)[0, ti, ci]
    s, abs_sum, exact, n = S.sum_terms(*ins)
    return dict(terms=terms, y=y, s=s[0, ti, ci], abs_sum=abs_sum[0, ti, ci],
                exact=exact[0, ti, ci], n=n)


def test_the_plain_version_rounds_the_exact_sum(element):
    # each product of two bf16 values is exact in f32: the f64 sum of the
    # terms is the exact sum (to 2^-53), and the plain version rounds it
    # to the card's plain value
    exact = float(element["terms"].sum())
    assert abs(float(element["exact"]) - exact) <= 1e-15
    assert abs(exact - 1.0039069226477) < 1e-12
    assert float(torch.tensor(exact).to(BF16)) == CARD_PLAIN_Y
    assert float(element["y"]) == CARD_PLAIN_Y
    assert float(element["s"].to(BF16)) == CARD_PLAIN_Y
    assert element["n"] == 3 * 512


def test_the_kernels_truncating_sum_gives_the_cards_value(element):
    terms = element["terms"]
    acc, nearest = 0.0, 0.0
    for c0 in range(0, 512, CHUNK):
        for tap in range(3):
            for k0 in range(c0, c0 + CHUNK, MMA_K):
                step = float(terms[tap, k0:k0 + MMA_K].sum())
                acc = _truncate_f32(acc + step)
                nearest = float(np.float32(nearest + step))
    # truncated: exactly the bf16 midpoint 1 + 2^-8, which rounds (to
    # even) to the card's kernel value; rounded to nearest, the plain one
    assert acc == 1.0 + 2.0 ** -8
    assert float(torch.tensor(acc).to(BF16)) == CARD_KERNEL_Y
    assert float(torch.tensor(nearest).to(BF16)) == CARD_PLAIN_Y
    # and each sum lies within its gamma_n of the exact sum
    n, abs_sum = element["n"], float(element["abs_sum"])
    exact = float(element["exact"])
    assert abs(acc - exact) <= _gamma(n, 2 * F32_U) * abs_sum
    assert abs(nearest - exact) <= _gamma(n, F32_U) * abs_sum


def test_the_tolerance_admits_the_element_by_its_rtol(element):
    # kernel and plain one bf16 step apart: rtol 2^-7 of |plain| alone
    # admits it, without the atol
    err = abs(CARD_KERNEL_Y - CARD_PLAIN_Y)
    rtol, atol = chip_smoke.SEP_Y_TOL[BF16]
    assert err <= rtol * CARD_PLAIN_Y
    assert 0.99 < err / (atol + rtol * CARD_PLAIN_Y) < 1.0
    got = torch.tensor([[[CARD_KERNEL_Y]]]).to(BF16)
    want = torch.tensor([[[CARD_PLAIN_Y]]]).to(BF16)
    none = torch.ones(1)
    _, bad, _, _ = chip_smoke.compare_block((got, none, none),
                                            (want, none, none), BF16)
    assert not bad.any()


def _away(v: torch.Tensor) -> torch.Tensor:
    """The next bf16 value away from zero: one step of v's binade."""
    _, e = torch.frexp(v.double())
    step = torch.ldexp(torch.ones_like(v, dtype=torch.float64), e - 8)
    return (v.double() + v.double().sign() * step).to(BF16)


@pytest.mark.parametrize("plain_is_larger", [True, False])
def test_one_bf16_step_always_passes_two_fail(plain_is_larger):
    # two f32 sums that round to neighbouring bf16 values pass at any
    # magnitude, across a power of two too. Two steps apart fail (at |y|
    # >= 1, where the atol decides nothing), but where the plain value is
    # a power of two and the kernel's two steps of the binade below it:
    # that is one step of the plain value's binade
    rng = np.random.default_rng(3)
    p2 = 2.0 ** np.arange(0, 7)
    mag = np.concatenate([p2, p2 * (1 - 2.0 ** -8), p2 * (1 - 2.0 ** -7),
                          rng.uniform(1.0, 100.0, 2000)])
    v = torch.tensor(mag * rng.choice([-1.0, 1.0], mag.size)).to(BF16)
    one = _away(v)
    two = _away(one)
    assert (one.double().abs() > v.double().abs()).all()
    assert (two.double().abs() > one.double().abs()).all()
    none = torch.ones(1)
    p2_two = torch.frexp(two.double())[0].abs() == 0.5
    for far, want_bad in ((one, torch.zeros_like(p2_two)),
                          (two, ~p2_two if plain_is_larger
                           else torch.ones_like(p2_two))):
        got, want = (v, far) if plain_is_larger else (far, v)
        _, bad, _, _ = chip_smoke.compare_block(
            (got.reshape(1, 1, -1), none, none),
            (want.reshape(1, 1, -1), none, none), BF16)
        assert torch.equal(bad.flatten(), want_bad)
    assert int(p2_two.sum()) >= len(p2)


def test_a_miss_reports_its_element_and_sums():
    x, w_dw, w_pw, a, b = separable_block_inputs(11, 64, 32, batch=4,
                                                 dtype=BF16)
    ins = (x, w_dw, w_pw, a, b)
    want = S.separable_block_plain(*ins)
    y = want[0].clone()
    at = (2, 5, 17)
    y[at] = (y[at].double() + 0.5).to(BF16)
    _, bad, _, _ = chip_smoke.compare_block((y, *want[1:]), want, BF16)
    assert torch.nonzero(bad).tolist() == [list(at)]
    (miss,) = chip_smoke.y_misses(y, want[0], bad, ins, fold_weights=True,
                                  emit_stats=True)
    s, abs_sum, exact, n = S.sum_terms(*ins)
    assert miss == {"at": list(at), "y": float(y[at]),
                    "y_plain": float(want[0][at]),
                    "plain_f32_sum": float(s[at]),
                    "f64_sum": float(exact[at]),
                    "abs_sum": float(abs_sum[at]), "n": 3 * 64}
    assert float(torch.tensor(miss["plain_f32_sum"]).to(BF16)) \
        == miss["y_plain"]


@pytest.mark.parametrize("fold", [True, False])
def test_sum_terms_are_the_plain_versions(fold):
    x, w_dw, w_pw, a, b = separable_block_inputs(20, 48, 40, batch=3,
                                                 dtype=BF16)
    kw = dict(stride=2, padding="SAME", fold_weights=fold)
    y = S.separable_block_plain(x, w_dw, w_pw, a, b, emit_stats=False, **kw)
    s, abs_sum, exact, n = S.sum_terms(x, w_dw, w_pw, a, b, **kw)
    assert n == (3 * 48 if fold else 48)
    assert torch.equal(s.to(BF16), y)
    assert (abs_sum >= s.abs()).all() and exact.dtype == torch.float64
    gamma = _gamma(n, F32_U)
    assert ((s.double() - exact).abs() <= gamma * abs_sum.double()).all()
