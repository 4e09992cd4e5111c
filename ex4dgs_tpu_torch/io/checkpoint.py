"""Training checkpoints: full optimizer-state-preserving save/resume.

The reference pickles a 40-tuple with torch (train.py:195-197,
c_gaussian_model.py:217-320). Here a compact HostModel (params + stats +
RAdam moments + counters) is written as a single .npz — multi-host
deterministic resume is just `pull -> save` on host 0 and `load -> push`
everywhere (the pushed arrays are replicated by the sharded step).

Counterpart of `ex4dgs_tpu/io/checkpoint.py`: the same .npz key layout
(`param:`, `stat:`, `mu:`, `nu:`, `extra:` and the five scalars), so a
checkpoint written by either package loads into the other.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..models.density import HostModel


def save_checkpoint(path: str, hm: HostModel, iteration: int,
                    extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "iteration": np.asarray(iteration),
        "step": np.asarray(hm.step),
        "active_sh_degree": np.asarray(hm.active_sh_degree),
        "duration": np.asarray(hm.duration),
        "keyframe_num": np.asarray(hm.keyframe_num),
    }
    for group, prefix in ((hm.params, "param"), (hm.stats, "stat"),
                          (hm.mu, "mu"), (hm.nu, "nu")):
        for k, v in group.items():
            payload[f"{prefix}:{k}"] = v
    for k, v in (extra or {}).items():
        payload[f"extra:{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str) -> tuple[HostModel, int, dict]:
    params, stats, mu, nu, extra = {}, {}, {}, {}, {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if ":" not in key:
                continue
            prefix, name = key.split(":", 1)
            {"param": params, "stat": stats, "mu": mu, "nu": nu,
             "extra": extra}[prefix][name] = z[key]
        hm = HostModel(
            params=params, stats=stats, mu=mu, nu=nu,
            step=int(z["step"]),
            active_sh_degree=int(z["active_sh_degree"]),
            duration=float(z["duration"]),
            keyframe_num=int(z["keyframe_num"]),
        )
        return hm, int(z["iteration"]), extra


def digest(hm: HostModel) -> str:
    """sha256 over every array and scalar of a HostModel, in a fixed order:
    equal digests mean bit-equal models and optimizer states."""
    h = hashlib.sha256()
    for group in (hm.params, hm.stats, hm.mu, hm.nu):
        for k in sorted(group):
            h.update(k.encode())
            h.update(np.ascontiguousarray(group[k]).tobytes())
    h.update(repr((hm.step, hm.active_sh_degree, hm.duration, hm.keyframe_num)).encode())
    return h.hexdigest()
