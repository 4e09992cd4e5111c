"""The layout probes P1 and P2 of ex4dgs_tpu_torch.probes against the TPU
probes of tools/tpu_probes/, run in Pallas interpret mode.

The TPU probe modules run their measurement when imported (P1 allocates
64 MiB and times 20 calls, P2 runs every kernel at T = 2752), so they are
not imported: each file is parsed, and only its imports, function
definitions and constant assignments are executed, with T and N rebound
small. P1's `kern` goes through `run`'s PrefetchScalarGridSpec with
interpret=True; P2's `run_a` ... `run_e` go through a `pl` whose
pallas_call is interpreted.

The plain versions must equal the TPU kernels exactly for P1 and P2 a-c
(copies and fills), and within 1e-6 of each tile's sum of |x| for P2 d and e
(a sum in another order). The `cuda` cases hold the CUDA kernels against the
plain versions on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_probes.py
"""
import ast
import functools
import pathlib
import types

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.probes import outspec, readings_ms, unaligned

torch.set_num_threads(2)

PROBES = pathlib.Path(__file__).resolve().parent.parent / "tools" / "tpu_probes"
N_SMALL, T_SMALL = 4096, 8  # P1: src f32[16, 4096], 8 windows
T_TILES = 3  # P2: tiles
SUM_RTOL = 1e-6  # P2 d/e: of each tile's sum of |x|


def _definitions(path: pathlib.Path, **rebind) -> dict:
    """A TPU probe module's imports, functions and call-free constants,
    executed without its measurement, with `rebind` applied after."""
    tree = ast.parse(path.read_text(), filename=str(path))
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign)
                and not any(isinstance(n, ast.Call) for n in ast.walk(node.value)))]
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    ns.update(rebind)
    return ns


def _jax_windows(src: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """_tpu_unaligned.py's kern through run's grid spec, interpreted."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    ns = _definitions(PROBES / "_tpu_unaligned.py", N=src.shape[1])
    rows, g, t = ns["ROWS"], ns["G"], offsets.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(t,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec((1, rows, g), lambda p, *_: (p, 0, 0),
                                memory_space=pltpu.VMEM)],
        scratch_shapes=[pltpu.VMEM((rows, g), jnp.float32), pltpu.SemaphoreType.DMA])
    f = pl.pallas_call(ns["kern"], grid_spec=grid_spec, interpret=True,
                       out_shape=[jax.ShapeDtypeStruct((t, rows, g), jnp.float32)])
    return np.asarray(f(jnp.asarray(offsets), jnp.asarray(src))[0])


@pytest.fixture(scope="module")
def outspec_ns():
    """_tpu_outspec.py's launchers at T = 3 tiles, interpreted."""
    from jax.experimental import pallas as pl

    shim = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                 BlockSpec=pl.BlockSpec)
    return _definitions(PROBES / "_tpu_outspec.py", T=T_TILES, pl=shim)


def test_probe_constants_match_the_tpu_probes():
    ns_u = _definitions(PROBES / "_tpu_unaligned.py")
    ns_o = _definitions(PROBES / "_tpu_outspec.py")
    assert (unaligned.N, unaligned.ROWS, unaligned.G, unaligned.T) == (
        ns_u["N"], ns_u["ROWS"], ns_u["G"], ns_u["T"])
    assert (outspec.T, outspec.N_PIX) == (ns_o["T"], ns_o["N_PIX"])


@pytest.mark.parametrize("label", ["aligned-256", "unaligned"])
def test_copy_windows_plain_matches_tpu_kernel(label):
    offs = unaligned.offset_sets(N_SMALL, T_SMALL)[label]
    assert offs.min() >= 0 and offs.max() <= N_SMALL - unaligned.G
    if label == "aligned-256":
        assert not (offs % 256).any()
    else:
        assert (offs % 4).any()  # starts that are not even 16-byte aligned
    src = unaligned.make_src(N_SMALL, "cpu")
    got = unaligned.copy_windows_plain(src, torch.from_numpy(offs)).numpy()
    want = _jax_windows(src.numpy(), offs)
    assert got.shape == (T_SMALL, 16, 256)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([src.numpy()[:, o:o + 256] for o in offs]))


def test_offset_sets_are_the_tpu_probes_draws():
    rng = np.random.default_rng(1)
    aligned = (rng.integers(0, (unaligned.N - 256) // 256, 4096) * 256).astype(np.int32)
    sets = unaligned.offset_sets()
    np.testing.assert_array_equal(sets["aligned-256"], aligned)
    np.testing.assert_array_equal(sets["unaligned"],
                                  rng.integers(0, unaligned.N - 256, 4096).astype(np.int32))


def test_window_bytes_counts_overlapping_columns_once():
    offs = torch.tensor([1000, 0, 10, 300, 300], dtype=torch.int32)
    covered = 10 + 256 + 256 + 256  # [0, 266) and [300, 556) and [1000, 1256)
    assert unaligned.window_bytes(offs) == 4 * 16 * covered + 4 * 16 * 256 * 5


def _outspec_inputs(kind: str):
    """Seeded normal or the probe's all-ones inputs of d and e."""
    rng = np.random.default_rng(5)
    shapes = {"d": [(T_TILES, 512, 8)] + [(T_TILES, 512, 1)] * 3, "e": [(T_TILES, 16, 512)]}
    make = ((lambda s: rng.normal(size=s)) if kind == "normal" else np.ones)
    return {k: [make(s).astype(np.float32) for s in v] for k, v in shapes.items()}


@pytest.mark.parametrize("key", ["a", "b", "c"])
def test_fill_plain_matches_tpu_kernel(outspec_ns, key):
    want = {"a": outspec_ns["run_a"], "b": outspec_ns["run_b"], "c": outspec_ns["run_c"]}[key]()
    got = {"a": outspec.fill_a_plain, "b": outspec.fill_b_plain,
           "c": outspec.fill_c_plain}[key](T_TILES, "cpu")
    want, got = (want, got) if key == "a" else ([want], [got])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == {np.float32: torch.float32, np.int32: torch.int32}[w.dtype.type]
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["normal", "ones"])
@pytest.mark.parametrize("key", ["d", "e"])
def test_sum_plain_matches_tpu_kernel(outspec_ns, key, kind):
    import jax.numpy as jnp

    ins = _outspec_inputs(kind)[key]
    want = np.asarray(outspec_ns[f"run_{key}"](*(jnp.asarray(x) for x in ins)))
    plain = outspec.sum_d_plain if key == "d" else outspec.sum_e_plain
    got = plain(*(torch.from_numpy(x) for x in ins)).numpy()
    assert got.shape == want.shape == (T_TILES, 16, 512)
    if kind == "ones":
        assert (got == outspec.ONES_SUM[key]).all() and (want == outspec.ONES_SUM[key]).all()
    abs_sum = sum(np.abs(x).sum(axis=(1, 2)) for x in ins)
    np.testing.assert_array_less(np.abs(got - want).max(axis=(1, 2)), SUM_RTOL * abs_sum + 1e-30)


def test_cpu_dispatch_takes_the_plain_versions():
    before = dict(kernels.launches)
    src = unaligned.make_src(N_SMALL, "cpu")
    offs = torch.from_numpy(unaligned.offset_sets(N_SMALL, T_SMALL)["unaligned"])
    assert torch.equal(unaligned.copy_windows(src, offs),
                       unaligned.copy_windows_plain(src, offs))
    for key, fn in outspec.calls(T_TILES, "cpu", outspec.probe_inputs(T_TILES, "cpu")).items():
        out = fn()
        out = out if key == "a" else (out,)
        want = outspec.fill_a_plain(T_TILES, "cpu") if key == "a" else (
            {"b": outspec.fill_b_plain(T_TILES, "cpu"), "c": outspec.fill_c_plain(T_TILES, "cpu"),
             "d": torch.full((T_TILES, 16, 512), 5632.0),
             "e": torch.full((T_TILES, 16, 512), 8192.0)}[key],)
        assert all(torch.equal(o, w) for o, w in zip(out, want)), key
    assert kernels.launches == before


def test_runs_on_the_cpu_at_a_small_size():
    r1 = unaligned.run("cpu", n=N_SMALL, t=T_SMALL, reps=2)
    r2 = outspec.run("cpu", t=T_TILES, reps=2)
    assert list(r1) == ["aligned-256", "unaligned"] and list(r2) == list("abcde")
    assert all(len(v) == 2 and min(v) >= 0 for v in (*r1.values(), *r2.values()))
    assert len(readings_ms(lambda: None, torch.device("cpu"), 3)) == 3


def _probe_args(n=1024, t=4):
    return [torch.zeros((16, n)), torch.zeros(t, dtype=torch.int32)]


@pytest.mark.parametrize("fault", ["cpu", "dtype", "rows", "offset_dtype", "negative",
                                   "past_end", "strided", "narrow_src"])
def test_unaligned_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """kernels.probe_unaligned refuses before anything is built (there is
    no nvcc here) and counts no launch."""
    args = _probe_args()
    match = None
    if fault == "dtype":
        args[0] = args[0].double()
    elif fault == "rows":
        args[0] = args[0][:14]
    elif fault == "offset_dtype":
        args[1] = args[1].long()
    elif fault == "negative":
        args[1][2], match = -1, "outside"
    elif fault == "past_end":
        args[1][0], match = 1024 - 255, "outside"
    elif fault == "strided":
        args[1] = torch.zeros(8, dtype=torch.int32)[::2]
    elif fault == "narrow_src":
        args[0] = torch.zeros((16, 200))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=match):
        kernels.probe_unaligned(*args)
    assert kernels.launches == before and not kernels._libs


@pytest.mark.parametrize("fault", ["a_cpu", "b_cpu", "c_cpu", "no_tiles", "d_cpu", "d_shape",
                                   "d_dtype", "d_tiles", "e_cpu", "e_shape"])
def test_outspec_wrappers_refuse_what_the_kernels_do_not_take(fault):
    f32 = dict(dtype=torch.float32)
    d_args = [torch.zeros((3, 512, 8), **f32)] + [torch.zeros((3, 512, 1), **f32)] * 3
    gin = torch.zeros((3, 16, 512), **f32)
    calls = {
        "a_cpu": lambda: kernels.outspec_a(3, "cpu"),
        "b_cpu": lambda: kernels.outspec_b(3, "cpu"),
        "c_cpu": lambda: kernels.outspec_c(3, "cpu"),
        "no_tiles": lambda: kernels.outspec_a(0, "cuda"),
        "d_cpu": lambda: kernels.outspec_d(*d_args),
        "d_shape": lambda: kernels.outspec_d(d_args[0][:, :, :7], *d_args[1:]),
        "d_dtype": lambda: kernels.outspec_d(*d_args[:3], d_args[3].double()),
        "d_tiles": lambda: kernels.outspec_d(*d_args[:3], d_args[3][:2]),
        "e_cpu": lambda: kernels.outspec_e(gin),
        "e_shape": lambda: kernels.outspec_e(gin[:, :8]),
    }
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        calls[fault]()
    assert kernels.launches == before and not kernels._libs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("label, n, t", [
    *(pytest.param(label, 1 << 16, 512, id=label) for label in ("aligned-256", "unaligned")),
    *(pytest.param(label, unaligned.N, unaligned.T, id=f"{label}-probe_size")
      for label in ("aligned-256", "unaligned"))])
def test_unaligned_kernel_matches_plain_on_card(cuda_device, label, n, t):
    """csrc/probe_unaligned.cu against the plain gather, every window
    exactly, two launches bit-equal; small, and at the probe's own size."""
    src = unaligned.make_src(n, cuda_device)
    offs = torch.from_numpy(unaligned.offset_sets(n, t)[label]).to(cuda_device)
    before = kernels.launches["probe_unaligned"]
    got = kernels.probe_unaligned(src, offs)
    again = kernels.probe_unaligned(src, offs)
    torch.cuda.synchronize()
    assert kernels.launches["probe_unaligned"] == before + 2
    assert torch.equal(got, unaligned.copy_windows_plain(src, offs)) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, t", [
    *(pytest.param(kind, 40, id=kind) for kind in ("normal", "ones")),
    *(pytest.param(kind, outspec.T, id=f"{kind}-probe_size") for kind in ("normal", "ones"))])
def test_outspec_kernels_match_plain_on_card(cuda_device, kind, t):
    """csrc/probe_outspec.cu against the plain versions: a-c exactly, d and
    e within 1e-6 of each tile's sum of |x| (exactly on all-ones inputs),
    two launches bit-equal; at 40 tiles and at the probe's T."""
    ins = {k: [torch.from_numpy(x).to(cuda_device) for x in v]
           for k, v in _outspec_inputs(kind).items()}
    ins = {k: [torch.cat([x] * (t // T_TILES + 1))[:t].contiguous() for x in v]
           for k, v in ins.items()}
    got = {"a": kernels.outspec_a(t), "b": (kernels.outspec_b(t),), "c": (kernels.outspec_c(t),),
           "d": (kernels.outspec_d(*ins["d"]),), "e": (kernels.outspec_e(*ins["e"]),)}
    again = {"d": kernels.outspec_d(*ins["d"]), "e": kernels.outspec_e(*ins["e"])}
    torch.cuda.synchronize()
    for key, want in (("a", outspec.fill_a_plain(t, cuda_device)),
                      ("b", (outspec.fill_b_plain(t, cuda_device),)),
                      ("c", (outspec.fill_c_plain(t, cuda_device),))):
        assert all(torch.equal(g, w) for g, w in zip(got[key], want)), key
    for key, plain in (("d", outspec.sum_d_plain), ("e", outspec.sum_e_plain)):
        out, want = got[key][0], plain(*ins[key])
        assert torch.equal(out, again[key]), key
        abs_sum = sum(x.abs().sum((1, 2)) for x in ins[key])
        assert bool(((out - want).abs().amax((1, 2)) <= SUM_RTOL * abs_sum).all()), key
        if kind == "ones":
            assert bool((out == outspec.ONES_SUM[key]).all()), key
