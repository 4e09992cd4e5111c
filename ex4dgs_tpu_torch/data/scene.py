"""Scene orchestration: loader dispatch, camera lists, temporal padding,
progressive sampling window, and threaded image prefetch.

Counterpart of `ex4dgs_tpu/data/scene.py`. Mirrors the reference Scene
(scene/__init__.py:40-281): cameras sorted by (timestamp, colmap_id),
duration auto-detect, reflect/repeat timepad, the `set_sampling_len`
progressive window, and lazy image loading — joblib/loky worker processes
replaced by a thread-pool prefetcher (decode releases the GIL in PIL) whose
frames live in a device-resident cache.
"""
from __future__ import annotations

import copy
import json
import os
import random
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device, upload

from .cameras import Camera, camera_from_info, camera_to_json
from .readers import SCENE_READERS, SceneInfo


def load_image(path: str, resolution: tuple[int, int], im_scale: float = 1.0):
    """Decode + resize to [H, W, 3] float32 in [0, 1] (cameras.py PILtoTorch
    analog, channel-last)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(path)
    img = img.resize(resolution, Image.Resampling.LANCZOS)
    arr = np.asarray(img, dtype=np.float32)[..., :3] / 255.0
    if im_scale != 1.0:
        arr = np.clip(arr / im_scale, 0.0, 1.0)
    return arr


class Scene:
    def __init__(self, cfg, scene_info: SceneInfo | None = None,
                 model_path: str | None = None, save_input: bool = False):
        """cfg: ModelConfig. scene_info may be injected (tests/synthetic)."""
        self.cfg = cfg
        self.model_path = model_path or cfg.model_path
        if scene_info is None:
            reader = SCENE_READERS.get(cfg.loader)
            if reader is None:
                raise ValueError(f"unknown loader {cfg.loader!r}")
            scene_info = reader(cfg.source_path, cfg)
        self.info = scene_info
        self.cameras_extent = float(scene_info.nerf_normalization["radius"])

        def im_scale_for(info):
            # per-camera exposure compensation (cameras.py:259-272)
            scale = 1.0
            sp = cfg.source_path
            nm = info.image_name
            if "01_Welder" in sp and "camera_0009" in nm:
                scale = 1.15
            if "12_Cave" in sp and "camera_0009" in nm:
                scale = 1.15
            if "04_Truck" in sp and "camera_0008" in nm:
                scale = 1.2
            return scale

        self.train_cameras = [
            camera_from_info(ci, i, cfg.resolution, im_scale=im_scale_for(ci))
            for i, ci in enumerate(scene_info.train_cameras)
        ]
        self.test_cameras = [
            camera_from_info(ci, i, cfg.resolution)
            for i, ci in enumerate(scene_info.test_cameras)
        ]
        self.train_cameras.sort(key=lambda c: (c.timestamp, c.colmap_id))
        self.test_cameras.sort(key=lambda c: (c.timestamp, c.colmap_id))

        unique_times = {c.timestamp for c in self.train_cameras}
        unique_cids = {c.colmap_id for c in self.train_cameras}
        self.cam_num = len(unique_cids)
        self.duration = cfg.duration
        if self.duration < 0:
            self.duration = max(
                len(unique_times), len({c.timestamp for c in self.test_cameras})
            )

        self.sample_len = self.duration
        self.min_timestamp = 0

        if save_input and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            cams = [camera_to_json(i, c)
                    for i, c in enumerate(self.test_cameras + self.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cams, f)

    # -- temporal padding (scene/__init__.py:125-163) ----------------------
    def apply_timepad(self, time_pad: int, pad_type: int) -> None:
        if pad_type == 0 or time_pad <= 0 or not self.train_cameras:
            return
        cams = self.train_cameras
        cid_len = self.cam_num
        times = [c.timestamp for c in cams]
        if pad_type == 1:  # reflect
            prefix = copy.deepcopy(cams[cid_len:cid_len * (time_pad + 1)])
            tmin = min(times)
            for c in prefix:
                c.timestamp = 2 * tmin - c.timestamp
            postfix = copy.deepcopy(cams[-cid_len * (time_pad + 1):-cid_len])
            tmax = max(times)
            for c in postfix:
                c.timestamp = 2 * tmax - c.timestamp
            cams = prefix + cams + postfix
        elif pad_type == 2:  # repeat
            first = cams[:cid_len]
            last = cams[-cid_len:]
            prefix, postfix = [], []
            for i in range(time_pad + 1):
                nf = copy.deepcopy(first)
                for c in nf:
                    c.timestamp -= i
                prefix = nf + prefix
                nl = copy.deepcopy(last)
                for c in nl:
                    c.timestamp += i
                postfix = postfix + nl
        else:
            raise ValueError(f"unknown time_pad_type {pad_type}")
        if pad_type == 2:
            cams = prefix + cams + postfix
        self.train_cameras = sorted(cams, key=lambda c: (c.timestamp, c.colmap_id))

    # -- progressive sampling window (scene/__init__.py:270-274) ------------
    def set_sampling_len(self, sample_len, min_timestamp=0, sample_every=1):
        self.sample_len = sample_len
        self.min_timestamp = min_timestamp
        self._sample = [
            (c.timestamp <= sample_len and c.timestamp >= min_timestamp
             and c.timestamp % sample_every == 0)
            for c in self.train_cameras
        ]
        self._test_sample = [c.timestamp <= sample_len for c in self.test_cameras]

    def sampled_train_cameras(self) -> list[Camera]:
        if not hasattr(self, "_sample"):
            self.set_sampling_len(self.sample_len)
        return [c for c, keep in zip(self.train_cameras, self._sample) if keep]

    def sampled_test_cameras(self) -> list[Camera]:
        if not hasattr(self, "_test_sample"):
            self.set_sampling_len(self.sample_len)
        return [c for c, keep in zip(self.test_cameras, self._test_sample) if keep]


class ImagePrefetcher:
    """Look-ahead image loader (replaces the reference's joblib generator,
    scene/__init__.py:199-204). Yields (camera, image) with `lookahead`
    decodes in flight; the image is a float32 [H, W, 3] tensor on `device`
    (cuda unless told otherwise), never a host array on the card's path.

    Decoding, as in the JAX package: with `native` (the default) PNG frames
    go to the native libpng pool (`native/`, a box-filter downsample, built
    with g++ at construction), any other file to PIL (LANCZOS) in a thread
    pool; where the native library cannot be built, every frame goes to
    PIL. Nothing of this is silent: `decoder` is "native" or "pil" (the
    pool this prefetcher took), `native_error` why the native pool is
    missing (None if it was not asked for or built), `decoded` counts the
    frames each decoder delivered (a PNG the native pool fails on is
    decoded by PIL and counted there), and `stats()` reports all of it
    with the cache's counters.

    device_cache_mb: budget of an LRU cache of decoded frames ON THE DEVICE
    (default EX4DGS_GT_CACHE_MB, 1024). Training revisits each frame every
    epoch, so a cached frame skips both the decode and the upload. Frames
    are evicted oldest first while the cached bytes exceed the budget (at
    least one stays). 0 disables the cache: every frame is decoded and
    uploaded (a cached ticket whose frame was evicted before it was
    served is decoded by PIL, as in JAX). `hits` counts frames served from
    the cache, `decodes` frames decoded; `decode_ms` holds each PIL
    decode's host-clock time in its worker thread, `wait_ms` the time the
    consumer waited on each decoded frame (either decoder) and `upload_ms`
    each upload's host time (staged in pinned memory and queued without
    blocking on a CUDA device: `upload`)."""

    def __init__(self, workers: int = 4, lookahead: int = 8, native: bool = True,
                 device_cache_mb: float | None = None, device=None):
        self.device = resolve_device(device)
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.lookahead = lookahead
        self.native = None
        self.native_error = None
        if native:
            try:
                from ..native import NativeImageLoader

                self.native = NativeImageLoader(workers)
            except Exception as e:  # no g++ or no libpng: PIL, recorded
                self.native_error = f"{type(e).__name__}: {e}"
        self.decoder = "native" if self.native is not None else "pil"
        if device_cache_mb is None:
            device_cache_mb = float(os.environ.get("EX4DGS_GT_CACHE_MB", 1024))
        self._cache_budget = int(device_cache_mb * 1024 * 1024)
        self._cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._cache_bytes = 0
        self.hits = 0
        self.decodes = 0
        self.decoded = {"native": 0, "pil": 0}
        self.decode_ms: list[float] = []
        self.wait_ms: list[float] = []
        self.upload_ms: list[float] = []

    def close(self) -> None:
        """Stop the decode threads and drop the cached frames."""
        self.pool.shutdown(wait=True, cancel_futures=True)
        if self.native is not None:
            self.native.close()
        self._cache.clear()
        self._cache_bytes = 0

    @property
    def cache_bytes(self) -> int:
        return self._cache_bytes

    def stats(self) -> dict:
        """The decoder and cache counters (the training report's GT-cache
        block)."""
        return {"decoder": self.decoder, "native_error": self.native_error,
                "decoded": dict(self.decoded), "hits": self.hits, "decodes": self.decodes,
                "bytes": self.cache_bytes, "decode_ms": self.decode_ms,
                "wait_ms": self.wait_ms, "upload_ms": self.upload_ms}

    @staticmethod
    def _cache_key(cam: Camera):
        return (cam.image_path, cam.width, cam.height, cam.im_scale)

    def _submit(self, cam: Camera):
        if self._cache_budget > 0:
            key = self._cache_key(cam)
            if key in self._cache:
                self._cache.move_to_end(key)
                return ("cached", key)
        if self.native is not None and cam.image_path.lower().endswith(".png"):
            return ("native", self.native.submit(cam.image_path, cam.width, cam.height,
                                                 cam.im_scale))
        return ("pil", self.pool.submit(self._decode, cam))

    def _decode(self, cam: Camera) -> np.ndarray:
        t0 = time.perf_counter()
        arr = load_image(cam.image_path, (cam.width, cam.height), cam.im_scale)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        return arr

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        self.decodes += 1
        img = upload(arr, self.device)
        self.upload_ms.append((time.perf_counter() - t0) * 1e3)
        return img

    def _cache_put(self, cam: Camera, img: torch.Tensor) -> torch.Tensor:
        """Pin a decoded frame on the device (LRU by bytes)."""
        key = self._cache_key(cam)
        old = self._cache.get(key)
        if old is not None:
            # overwrite (duplicate cameras sharing image_path within the
            # lookahead window): replace without double-counting bytes
            self._cache_bytes -= old.nbytes
        self._cache[key] = img
        self._cache_bytes += img.nbytes
        while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= old.nbytes
        return img

    def _wait(self, kind: str, h, cam: Camera) -> np.ndarray:
        """The decoded frame of a ticket, counted under the decoder that
        delivered it."""
        t0 = time.perf_counter()
        if kind == "native":
            try:
                arr = self.native.wait(h)
            except IOError:
                kind, arr = "pil", self._decode(cam)
        elif kind == "pil":
            arr = h.result()
        else:  # a cached ticket that outlived its entry: PIL, as in JAX
            kind, arr = "pil", self._decode(cam)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        self.decoded[kind] += 1
        return arr

    def _result(self, handle, cam: Camera) -> torch.Tensor:
        kind, h = handle
        if kind == "cached":
            hit = self._cache.get(h)
            if hit is not None:
                self.hits += 1
                return hit
            # The ticket outlived its entry: up to `lookahead` 'cached'
            # tickets can be outstanding while interleaved _cache_put
            # evictions (budget < ~lookahead+1 frames) pop the key. Degrade
            # to a decode instead of failing the epoch.
            img = self._upload(self._wait(kind, h, cam))
            return self._cache_put(cam, img)
        img = self._upload(self._wait(kind, h, cam))
        if self._cache_budget > 0:
            return self._cache_put(cam, img)
        return img

    def load(self, cam: Camera) -> torch.Tensor:
        """One camera's frame on the device, through the cache, with no
        look-ahead (a sharded trainer's rank loads only its own camera)."""
        return self._result(self._submit(cam), cam)

    def epoch(self, cameras: list[Camera], shuffle: bool = True, rng=None):
        cams = list(cameras)
        if shuffle:
            (rng or random).shuffle(cams)
        handles = []
        for cam in cams[: self.lookahead]:
            handles.append(self._submit(cam))
        consumed = min(self.lookahead, len(cams))
        i = 0
        while i < len(cams):
            img = self._result(handles[i], cams[i])
            if consumed < len(cams):
                handles.append(self._submit(cams[consumed]))
                consumed += 1
            yield cams[i], img
            i += 1
