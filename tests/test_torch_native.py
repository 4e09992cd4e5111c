"""ex4dgs_tpu_torch's native libpng loader (`native/`) and the prefetcher's
choice of decoder, against the JAX package (tests/test_native.py on the
port).

- tests/test_native.py's two cases: the loader's decode against PIL (exact
  up to the 1/255 step at full resolution, close on smooth content when
  downsampled, the exposure scale, many tickets waited out of order) and
  the prefetcher handing out every frame;
- the port's library decodes bit-equal to JAX's `NativeImageLoader` on the
  same PNGs (full size, box-downsampled, exposure-scaled), and it is built
  into the package's `_build/`, not beside its source;
- the prefetcher reports its decoder: "native" where the library builds,
  "pil" when asked (`native=False`) or when the build fails (with the
  reason), and non-PNG files go to PIL under the native pool;
  `load_image` (the eval path's decoder) stays PIL.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_native.py
"""
import os

import numpy as np
import pytest

from ex4dgs_tpu_torch.data.scene import ImagePrefetcher, load_image


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        arr = rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
        p = str(d / f"f{i}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    yy, xx = np.mgrid[0:96, 0:128]
    smooth = np.stack([xx * 2, yy * 2, (xx + yy)], -1).astype(np.uint8)
    p = str(d / "smooth.png")
    Image.fromarray(smooth).save(p)
    paths.append(p)
    return paths


@pytest.fixture(scope="module")
def loader():
    from ex4dgs_tpu_torch.native import NativeImageLoader

    try:
        ld = NativeImageLoader(2)
    except RuntimeError as e:
        pytest.fail(f"the native loader does not build where g++ and libpng are: {e}")
    yield ld
    ld.close()


def _cameras(paths, width=64, height=48):
    from ex4dgs_tpu_torch.data.cameras import Camera

    return [Camera(colmap_id=i, uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                   image_name=os.path.basename(p), image_path=p, width=width, height=height,
                   near=0.1, far=10.0, timestamp=float(i))
            for i, p in enumerate(paths)]


def test_native_loader_matches_pil(png_files, loader):
    # full resolution: the same bytes over 255 (no resampling)
    native = loader.wait(loader.submit(png_files[0], 128, 96, 1.0))
    np.testing.assert_allclose(native, load_image(png_files[0], (128, 96), 1.0),
                               atol=1 / 255 + 1e-6)
    # downsampled: box against LANCZOS agree closely on smooth content
    native = loader.wait(loader.submit(png_files[6], 64, 48, 1.0))
    pil = load_image(png_files[6], (64, 48), 1.0)
    assert native.shape == pil.shape == (48, 64, 3)
    assert np.abs(native - pil).mean() < 0.01
    # exposure scale
    scaled = loader.wait(loader.submit(png_files[2], 64, 48, 2.0))
    base = loader.wait(loader.submit(png_files[2], 64, 48, 1.0))
    np.testing.assert_allclose(scaled, np.clip(base / 2.0, 0, 1), atol=2e-3)
    # many tickets in flight, waited out of order
    tickets = [loader.submit(p, 64, 48, 1.0) for p in png_files]
    for t in reversed(tickets):
        img = loader.wait(t)
        assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    with pytest.raises(IOError):
        loader.wait(loader.submit(png_files[0] + ".missing", 64, 48, 1.0))


def test_native_loader_bit_equal_to_jax(png_files, loader):
    from ex4dgs_tpu.native import NativeImageLoader as JNativeImageLoader
    from ex4dgs_tpu_torch import native

    jl = JNativeImageLoader(2)
    try:
        for p in png_files:
            for w, h, scale in ((128, 96, 1.0), (64, 48, 1.0), (50, 37, 1.0), (64, 48, 1.15),
                                (200, 150, 1.0)):
                got = loader.wait(loader.submit(p, w, h, scale))
                want = jl.wait(jl.submit(p, w, h, scale))
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=f"{p} {w}x{h} x{scale}")
    finally:
        jl.close()
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "_build" and lib.parent != native.SRC.parent


def test_prefetcher_uses_native(png_files):
    cams = _cameras(png_files[:6])
    pf = ImagePrefetcher(workers=2, lookahead=3, device="cpu")
    seen = []
    for cam, img in pf.epoch(cams, shuffle=False):
        assert img.shape == (48, 64, 3)
        seen.append(cam.colmap_id)
    assert seen == list(range(6))
    assert pf.decoder == "native" and pf.native_error is None
    assert pf.decoded == {"native": 6, "pil": 0}
    stats = pf.stats()
    assert stats["decoder"] == "native" and stats["decodes"] == 6 and len(stats["wait_ms"]) == 6
    pf.close()


def test_prefetcher_decodes_as_jax(png_files):
    """The port's prefetcher and JAX's hand out the same frames, both on
    their native pools and both on PIL."""
    from ex4dgs_tpu.data.scene import ImagePrefetcher as JPrefetcher

    cams = _cameras(png_files, width=50, height=37)
    for native in (True, False):
        pf = ImagePrefetcher(workers=2, lookahead=3, native=native, device="cpu")
        jpf = JPrefetcher(workers=2, lookahead=3, native=native, device_cache_mb=0)
        assert pf.decoder == ("native" if native else "pil")
        assert (jpf.native is not None) == native
        for (c, img), (jc, jimg) in zip(pf.epoch(cams, shuffle=False),
                                        jpf.epoch(cams, shuffle=False)):
            assert c.image_path == jc.image_path
            np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
        assert pf.decoded == {"native": len(cams) if native else 0,
                              "pil": 0 if native else len(cams)}
        pf.close()
        if jpf.native is not None:
            jpf.native.close()


def test_prefetcher_records_pil_when_native_fails(png_files, tmp_path, monkeypatch):
    """Where the library cannot be built the prefetcher takes PIL and says
    so; a non-PNG file goes to PIL under the native pool."""
    from PIL import Image

    from ex4dgs_tpu_torch import native

    def no_build(*a, **k):
        raise RuntimeError("native loader build failed: no g++ here")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", no_build)
    pf = ImagePrefetcher(workers=1, lookahead=2, device="cpu")
    assert pf.decoder == "pil" and "no g++" in pf.native_error
    cams = _cameras(png_files[:2])
    for cam, img in pf.epoch(cams, shuffle=False):
        np.testing.assert_array_equal(img.numpy(), load_image(cam.image_path, (64, 48)))
    assert pf.decoded == {"native": 0, "pil": 2} and pf.stats()["decoder"] == "pil"
    pf.close()
    monkeypatch.undo()

    jpg = str(tmp_path / "frame.jpg")
    Image.open(png_files[0]).save(jpg, quality=95)
    pf = ImagePrefetcher(workers=1, lookahead=2, device="cpu")
    assert pf.decoder == "native"
    (cam, img), = pf.epoch(_cameras([jpg]), shuffle=False)
    np.testing.assert_array_equal(img.numpy(), load_image(jpg, (64, 48)))
    assert pf.decoded == {"native": 0, "pil": 1}
    pf.close()
