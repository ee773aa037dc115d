"""Checkpoint/resume for long renders: the JAX package's format
(`lumillyrender_tpu/utils/checkpoint.py`), kept here so that the port
imports nothing of that package.

Counter-based RNG makes resuming exact: the film SUM and the number of
completed samples are the entire state; the next chunk's lanes derive their
streams from (seed, global sample index) and reproduce exactly what an
uninterrupted render would have computed. A checkpoint is an `.npz` with
`film_sum` (H, W, 3) float32 and `meta`, a JSON string of the format
version, samples done, seed, total rays and the settings; it is written to
`<path>.tmp` and then moved over `path` in one step, so a crash never
leaves a broken checkpoint.

The port's RenderSettings has the JAX package's fields, `fused` included,
and `load` compares them as JSON gives them back (a tuple as a list): it
takes a checkpoint the JAX package wrote whose settings match. The JAX
package's `load` compares the saved list of `mat_types` with its own
tuple, which never match, so it refuses the port's checkpoints.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path

import numpy as np

FORMAT_VERSION = 1


def _settings_json(settings) -> dict:
    return json.loads(json.dumps(asdict(settings)))


def save(path, film_sum: np.ndarray, samples_done: int, seed: int,
         settings, total_rays: float) -> None:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    meta = dict(
        version=FORMAT_VERSION,
        samples_done=int(samples_done),
        seed=int(seed),
        total_rays=float(total_rays),
        settings=asdict(settings),
    )
    with open(tmp, "wb") as f:  # a file handle: numpy appends no ".npz"
        np.savez_compressed(f, film_sum=film_sum, meta=json.dumps(meta))
    tmp.replace(path)


def load(path, settings, seed: int):
    """(film_sum, samples_done, total_rays), or None where the file is
    absent or was written for another render: another format version, seed,
    or any setting but spp (a render may be extended to more samples)."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != FORMAT_VERSION or meta.get("seed") != seed:
            return None
        saved = meta["settings"]
        for k, v in _settings_json(settings).items():
            if k != "spp" and saved.get(k) != v:
                return None
        return (
            np.asarray(z["film_sum"], np.float32),
            int(meta["samples_done"]),
            float(meta["total_rays"]),
        )
