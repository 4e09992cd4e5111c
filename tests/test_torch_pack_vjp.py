"""The pack VJP (ops/rasterize_cuda.py::PackSorted.backward): its plain
version `pack_vjp_plain` on the CPU and the kernel csrc/pack_vjp.cu
(`kernels.pack_vjp`) on the card.

- pack_vjp_plain's float64 sums, rounded to float32 once, are a float64
  `np.add.at` rounded once, within half an ulp, on segments of 0, 1, 7 and
  3,000 instances;
- its order of sums is the documented one, bit for bit: each Gaussian's
  m-th instance goes to running sum m % 32, and the 32 sums are added at
  distances 16, 8, 4, 2, 1 (`_lane_order`, a loop over the Gaussians);
- a segment of -0.0 sums to +0.0;
- tail slots, and slots past the capacity when the expansion overflows it,
  are summed into nothing; two calls give the same bits; an instance moved
  to the end of the sorted order with a zero cotangent (the tight cull's)
  leaves every bit as it was;
- PackSorted's VJP on CPU tensors is pack_vjp_plain and counts no launch.

The `cuda` cases: the kernel bit-equal to pack_vjp_plain at n3v's capacity
(917,504 slots, 110,000 rows) and at n3v_4dgs's (4,063,232 slots, 503,808
rows), each with Gaussians of thousands of instances, within half an ulp of
a float64 sum, two launches bit-equal; the wrapper refuses a wrong dtype,
shape, device or layout on the card. (The refusals on CPU tensors are in
tests/test_torch_package.py; the launches of train_step and train_step_4d
in tests/test_torch_graph.py and tests/test_torch_fourdgs.py.)

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pack_vjp.py
    python -m pytest --noconftest -m cuda tests/test_torch_pack_vjp.py
"""
import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc


def _case(counts, capacity, seed=0, tail=1e3):
    """(ct f32 [16, capacity], slot i32 [capacity], cum, counts i32 [P]):
    the live expansion slots shuffled over the first sorted columns, the
    tail slots after them in order with cotangent `tail`, and cotangents
    over six decades."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    cum = np.cumsum(counts, dtype=np.int64)
    live = min(int(cum[-1]), capacity)
    slot = np.concatenate([rng.permutation(live), np.arange(live, capacity)]).astype(np.int32)
    ct = (rng.normal(size=(16, capacity)) * 10.0 ** rng.uniform(-3, 3, (16, capacity)))
    ct = ct.astype(np.float32)
    ct[:, live:] = tail
    return (torch.from_numpy(ct), torch.from_numpy(slot), torch.from_numpy(cum.astype(np.int32)),
            torch.from_numpy(counts))


def _exact(ct, slot, cum, counts):
    """float64 [16, P]: np.add.at of every live column into its Gaussian."""
    capacity, P = ct.shape[1], cum.shape[0]
    cum = cum.numpy().astype(np.int64)
    live = min(int(cum[-1]), capacity)
    s = slot.numpy().astype(np.int64)
    keep = s < live
    g = np.searchsorted(cum, s[keep], side="right")
    out = np.zeros((P, 16))
    np.add.at(out, g, ct.numpy()[:, keep].T.astype(np.float64))
    return out.T


def _lane_order(ct, slot, cum, counts):
    """float32 [16, P] by the documented order, one Gaussian at a time."""
    capacity, P = ct.shape[1], cum.shape[0]
    ct64 = ct.numpy().astype(np.float64)
    inv = np.empty(capacity, np.int64)
    inv[slot.numpy()] = np.arange(capacity)
    out = np.zeros((16, P), np.float32)
    for g in range(P):
        hi = min(max(int(cum[g]), 0), capacity)
        lo = min(max(int(cum[g]) - int(counts[g]), 0), capacity)
        if hi <= lo:
            continue
        lanes = np.zeros((32, 16))
        for m, j in enumerate(range(lo, hi)):
            lanes[m % 32] = lanes[m % 32] + ct64[:, inv[j]]
        for dist in (16, 8, 4, 2, 1):
            lanes = lanes[:dist] + lanes[dist:2 * dist]
        out[:, g] = lanes[0].astype(np.float32)
    return out


def _negative_zeros(case, gaussians, share, seed):
    """`case` with every instance of `gaussians` and a `share` of the other
    cotangent entries set to -0.0 (kernel B can give -0.0: a product with a
    zero weight)."""
    ct, slot, cum, counts = case
    ct = ct.clone()
    rng = np.random.default_rng(seed)
    ct[torch.from_numpy(rng.random(tuple(ct.shape)) < share)] = -0.0
    inv = torch.argsort(slot.long())
    for g in gaussians:
        ct[:, inv[int(cum[g]) - int(counts[g]):int(cum[g])]] = -0.0
    return ct, slot, cum, counts


def _assert_half_ulp(got, exact):
    """got (float32) is the float64 `exact` rounded once: within half an
    ulp of it (6e-8 relative)."""
    np.testing.assert_allclose(got.numpy().astype(np.float64), exact, rtol=6e-8, atol=1e-30)


@pytest.mark.parametrize("length", [0, 1, 7, 3000])
def test_plain_sums_are_float64_sums_rounded_once(length):
    """A segment of `length` instances among short ones (and empty ones):
    within half an ulp of np.add.at in float64, and in the documented
    order bit for bit."""
    rng = np.random.default_rng(length)
    counts = rng.integers(0, 9, 60)
    counts[[3, 17, 40]] = 0
    counts[25] = length
    case = _case(counts, int(counts.sum()) + 100, seed=length)
    got = trc.pack_vjp_plain(*case)
    assert got.dtype == torch.float32 and got.shape == (16, 60)
    _assert_half_ulp(got, _exact(*case))
    assert np.array_equal(got.numpy(), _lane_order(*case))
    assert not got[:, counts == 0].any()
    if length:
        assert bool(got[:, 25].ne(0).all())


def test_plain_order_is_the_lanes_at_every_length():
    """Segments of every length from 0 to 100 and a few past 32 k + 1:
    pack_vjp_plain gives the loop's bits."""
    counts = np.concatenate([np.arange(101), [129, 160, 161, 257, 1000]])
    case = _case(counts, int(counts.sum()) + 7, seed=11)
    assert np.array_equal(trc.pack_vjp_plain(*case).numpy(), _lane_order(*case))


def test_plain_sums_of_negative_zeros_are_positive_zero():
    """A segment of -0.0 sums to +0.0 (each running sum starts from +0.0),
    as the float64 oracle and the documented order give it; -0.0 elsewhere
    changes no other bit."""
    counts = np.array([3, 1, 40, 0, 7, 2, 33], np.int32)
    case = _case(counts, int(counts.sum()) + 5, seed=4)
    got = trc.pack_vjp_plain(*_negative_zeros(case, [1, 2, 4], 0.05, seed=4))
    assert np.array_equal(got.numpy(), _lane_order(*_negative_zeros(case, [1, 2, 4], 0.05, 4)))
    assert not got[:, [1, 2, 4]].view(torch.int32).any()  # +0.0, not -0.0
    assert bool(got[:, [0, 5, 6]].ne(0).all())


def test_plain_ignores_the_tail_and_what_overflows():
    """Tail slots sum into nothing, whatever they hold; when the expansion
    overflows the capacity, the segment that straddles it sums its slots
    below the capacity and the Gaussians past it get 0."""
    counts = np.array([5, 0, 40, 3, 12, 6, 9], np.int32)
    a = trc.pack_vjp_plain(*_case(counts, 90, seed=2, tail=0.0))
    b = trc.pack_vjp_plain(*_case(counts, 90, seed=2, tail=np.float32(3e38)))
    assert torch.equal(a, b)
    over = _case(counts, 64, seed=3)  # total 75: Gaussian 5 straddles, 6 lies past
    got = trc.pack_vjp_plain(*over)
    _assert_half_ulp(got, _exact(*over))
    assert np.array_equal(got.numpy(), _lane_order(*over))
    assert not got[:, 6].any() and bool(got[:, 5].ne(0).all())


def test_plain_is_deterministic_and_a_culled_instance_changes_no_bit():
    """Two calls give the same bits. With the tight cull, a culled
    instance keeps its expansion slot but its sorted column moves past the
    live ones, with a zero cotangent either way: every sum keeps its bits."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 40, 300)
    ct, slot, cum, counts_t = _case(counts, int(counts.sum()) + 50, seed=5)
    live = int(cum[-1])
    culled = torch.from_numpy(rng.choice(live, 200, replace=False))
    ct_off = ct.clone()
    ct_off[:, culled] = 0.0
    off = trc.pack_vjp_plain(ct_off, slot, cum, counts_t)
    assert torch.equal(off, trc.pack_vjp_plain(ct_off, slot, cum, counts_t))
    # cull on: the culled columns go last among the live ones, in order
    keep = torch.ones(live, dtype=torch.bool)
    keep[culled] = False
    moved = torch.cat([torch.nonzero(keep).squeeze(1), torch.sort(culled).values,
                       torch.arange(live, ct.shape[1])])
    on = trc.pack_vjp_plain(ct_off[:, moved].contiguous(), slot[moved].contiguous(), cum,
                            counts_t)
    assert torch.equal(on, off) and bool(off.ne(0).any())


def test_pack_sorted_vjp_on_cpu_is_the_plain_version():
    """PackSorted's backward on CPU tensors takes pack_vjp_plain and counts
    no launch."""
    counts = np.array([3, 0, 70, 1, 9], np.int32)
    ct, slot, cum, counts_t = _case(counts, 96, seed=8, tail=0.0)
    rows = torch.randn((16, 5), requires_grad=True)
    by_slot = np.minimum(np.searchsorted(cum.numpy(), np.arange(96), side="right"), 4)
    order = torch.from_numpy(by_slot[slot.numpy()].astype(np.int32))
    before = dict(kernels.launches)
    data = trc.PackSorted.apply(rows, order, cum, counts_t, slot)
    (g,) = torch.autograd.grad(data, rows, grad_outputs=ct)
    assert kernels.launches == before
    assert torch.equal(g, trc.pack_vjp_plain(ct, slot, cum, counts_t))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


# (capacity, rows): n3v's (110,000 splats) and n3v_4dgs's (500,000 4D
# Gaussians in 503,808 rows, 8 slots a row)
CARD_SHAPES = {"n3v": (917_504, 110_000), "n3v_4dgs": (4_063_232, 503_808)}


def card_case(capacity: int, P: int, seed: int = 0):
    """A view's pack VJP inputs at a cell's shape: about 30% of the rows
    visible, touching 1-12 tiles, three splats over thousands of tiles
    (3,000, 5,440: the whole 1352x1014 frame at 16x16 tiles, and 1,600),
    the tail filled with 1e3, and -0.0 in 1% of the entries and in every
    entry of 50 short segments."""
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random(P) < 0.3, rng.integers(1, 13, P), 0).astype(np.int32)
    counts[rng.choice(P, 3, replace=False)] = [3000, 5440, 1600]
    assert counts.sum() <= capacity
    zeros = rng.choice(np.flatnonzero((counts > 0) & (counts <= 32)), 50, replace=False)
    return _negative_zeros(_case(counts, capacity, seed=seed), zeros, 0.01, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_is_the_plain_version_bit_for_bit_on_card(cuda_device, shape):
    capacity, P = CARD_SHAPES[shape]
    case_cpu = card_case(capacity, P, seed=len(shape))
    case = [x.to(cuda_device) for x in case_cpu]
    before = kernels.launches["pack_vjp"]
    got = kernels.pack_vjp(*case)
    again = kernels.pack_vjp(*case)
    torch.cuda.synchronize()
    assert kernels.launches["pack_vjp"] == before + 2
    assert torch.equal(got, again)
    want = trc.pack_vjp_plain(*case)
    diff = (got - want).abs()
    assert torch.equal(got, want), (diff.max().item(), int((diff > 0).sum()))
    _assert_half_ulp(got.cpu(), _exact(*case_cpu))


WRAPPER_FAULTS = ("dtype", "shape", "slot_dtype", "cum_shape", "device", "strided")


def wrapper_fault(fault, device):
    """kernels.pack_vjp's arguments for three Gaussians over 32 slots on
    `device`, with one of WRAPPER_FAULTS (None: none); "device" moves
    counts to another device. Shared with tests/test_torch_package.py,
    which passes CPU tensors."""
    ct, slot, cum, counts = [x.to(device) for x in _case([4, 0, 9], 32)]
    if fault == "dtype":
        ct = ct.double()
    elif fault == "shape":
        ct = ct[:15].contiguous()
    elif fault == "slot_dtype":
        slot = slot.long()
    elif fault == "cum_shape":
        cum = cum[:2]
    elif fault == "device":
        counts = counts.to("meta" if torch.device(device).type == "cpu" else "cpu")
    elif fault == "strided":
        ct = torch.empty((32, 16), device=device).t()
    else:
        assert fault is None, fault
    return ct, slot, cum, counts


@pytest.mark.cuda
@pytest.mark.parametrize("fault", WRAPPER_FAULTS)
def test_kernel_wrapper_refuses_on_card(cuda_device, fault):
    """kernels.pack_vjp refuses what the kernel does not take, and counts
    no launch."""
    args = wrapper_fault(fault, cuda_device)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.pack_vjp(*args)
    assert kernels.launches == before
