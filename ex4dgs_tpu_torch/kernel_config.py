"""Rasterizer knobs the render path reads.

The counterpart of `ex4dgs_tpu/kernel_config.py`, cut to the knobs this port
uses. The JAX package binds its knobs as module globals; here a config is a
value the caller passes (rendering.render(..., kernel_cfg=...)), so two
configurations can live in one process.

  tile_x, tile_y  tile shape in pixels (default 32x16; the golden render
                  pins 16x16, the reference's own tile)
  exact_sort      binning depth order: False = packed 31-bit key (ties
                  within ~2^-10 relative depth blend in Gaussian order),
                  True = exact (tile, float depth) order
  tight_cull      binning drops a tile's instance where a box bound of its
                  conic over the tile's pixels (1 px margin) proves alpha
                  below the 1/255 floor everywhere (ops/binning.py); the
                  JAX package's EX4DGS_TIGHT_CULL, default off

Tiles become the image by compositing.tiles_to_image, the JAX package's
default ("naive") assembly; it has no alternative here, so it is no knob.

`KernelConfig.from_env()` reads the JAX package's environment variables
for these knobs (EX4DGS_TILE, EX4DGS_EXACT_SORT, EX4DGS_TIGHT_CULL); the
training CLI, the render CLI, `eval/render_sets.py`, `quality.py` and the
bench render with it.

A checkpoint records the config as `to_json()` (`extra:kernel_config`).
`from_dict` reads the port's record and the JAX package's alike: it takes
tile_x, tile_y, exact_sort and tight_cull, and ignores the JAX package's
TPU-only knobs (pair, g_chunk, win_align, bufs, pair_fwd, aligned_layout,
kernel_dot, power, pack_vjp, ssim_blur, scan_dot, untile), which shape
Pallas kernels the port does not have.
"""
from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    tile_x: int = 32
    tile_y: int = 16
    exact_sort: bool = False
    tight_cull: bool = False

    @property
    def n_pix(self) -> int:
        return self.tile_x * self.tile_y

    def validate(self) -> "KernelConfig":
        if self.tile_x < 1 or self.tile_y < 1:
            raise ValueError(f"invalid KernelConfig {self}: tile sides must be >= 1")
        # one CUDA thread per tile pixel: a block holds at most 1024 threads
        if self.n_pix > 1024 or self.n_pix % 32:
            raise ValueError(
                f"invalid KernelConfig {self}: tile area must be a multiple "
                "of 32 (one warp) and at most 1024 (one thread block)")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_dict(d: dict) -> "KernelConfig":
        """The config recorded in `d` (the port's `to_json()` or the JAX
        package's, parsed): its tile shape, sort and tight cull; other keys
        are ignored."""
        base = KernelConfig()
        return KernelConfig(tile_x=int(d.get("tile_x", base.tile_x)),
                            tile_y=int(d.get("tile_y", base.tile_y)),
                            exact_sort=bool(d.get("exact_sort", base.exact_sort)),
                            tight_cull=bool(d.get("tight_cull", base.tight_cull))).validate()

    @staticmethod
    def from_env() -> "KernelConfig":
        """The config the environment asks for, parsed as the JAX package's
        `KernelConfig.from_env` parses it: EX4DGS_TILE as "<x>x<y>"
        (default 32x16), EX4DGS_EXACT_SORT and EX4DGS_TIGHT_CULL on where
        they are "1"; validated, so a tile the kernels cannot take raises.

        The JAX package's TPU-only variables are ignored: EX4DGS_PAIR,
        EX4DGS_GCHUNK, EX4DGS_ALIGN, EX4DGS_BUFS, EX4DGS_PAIR_FWD,
        EX4DGS_ALIGNED_LAYOUT, EX4DGS_KERNEL_DOT, EX4DGS_POWER,
        EX4DGS_PACK_VJP, EX4DGS_SSIM_BLUR, EX4DGS_SCAN_DOT and EX4DGS_UNTILE.
        Each call reads the environment anew (nothing is cached)."""
        tx, ty = (int(v) for v in os.environ.get("EX4DGS_TILE", "32x16").lower().split("x"))
        return KernelConfig(tile_x=tx, tile_y=ty,
                            exact_sort=os.environ.get("EX4DGS_EXACT_SORT", "0") == "1",
                            tight_cull=os.environ.get("EX4DGS_TIGHT_CULL", "0") == "1").validate()
