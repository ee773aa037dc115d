"""One rank of the port's 2-rank gloo group on the CPU.

Started twice by tests/test_torch_shard.py with LLR_COORDINATOR /
LLR_NUM_PROCESSES / LLR_PROCESS_ID set, as tests/multihost_worker.py is for
the JAX package. Renders multihost_worker.SCENE through
`parallel.shard.render_sharded` (16 spp, and 6 spp, whose tail chunk is
padded) and takes one `sharded_train_step`; rank 0 saves what it got to
LLR_TEST_OUT (.npz), and each rank checks that it holds rank 0's film.
Imports nothing of JAX.

Not a test module itself (no `test_` prefix); all side effects live in
main().
"""

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SPP_PER_DEVICE = 2
TAIL_SPP = 6  # chunks of 4 samples: the second is padded, the film divided by 8
TRAIN_SPP_LOCAL = 2
TRAIN_MAX_BOUNCES = 5
TRAIN_ROW, TRAIN_VALUE = 2, 0.15  # the gray ball's red albedo, perturbed
TARGET = 0.1  # the target film, constant


def main() -> None:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import dataclasses

    import numpy as np
    import torch

    from lumillyrender_tpu_torch.convert import params_to_numpy
    from lumillyrender_tpu_torch.diff import params_of
    from lumillyrender_tpu_torch.parallel import shard
    from lumillyrender_tpu_torch.scene.compiler import compile_scene
    from lumillyrender_tpu_torch.scene.loader import parse_config
    from multihost_worker import SCENE, SEED

    torch.set_num_threads(1)
    assert shard.init_distributed(device="cpu"), "LLR_COORDINATOR is not set"
    rank, world = shard.ranks()
    assert world == 2, world

    out = {}
    full = compile_scene(parse_config(SCENE), device="cpu")
    r = shard.render_sharded(full, seed=SEED, n_devices=2, spp_per_device=SPP_PER_DEVICE,
                             device="cpu")
    out["film"], out["rays"] = r.film, np.float64(r.rays)
    tail = compile_scene(parse_config(SCENE), spp=TAIL_SPP, device="cpu")
    r = shard.render_sharded(tail, seed=SEED, spp_per_device=SPP_PER_DEVICE, device="cpu")
    out["tail_film"] = r.film

    settings = dataclasses.replace(full.settings, max_bounces=TRAIN_MAX_BOUNCES)
    params = params_of(full.data)
    color = params.materials.color.clone()
    color[TRAIN_ROW, 0] = TRAIN_VALUE
    params = params._replace(materials=dataclasses.replace(params.materials, color=color))
    target = torch.full((settings.height, settings.width, 3), TARGET)
    loss, grads = shard.sharded_train_step(full.data, settings, params, target,
                                           np.arange(world * TRAIN_SPP_LOCAL), device="cpu")
    out["loss"] = loss.numpy()
    for part, fields in params_to_numpy(grads).items():
        for field, g in fields.items():
            out[f"grad.{part}.{field}"] = g

    # Every rank holds the same film: rank 0's, broadcast here for the check.
    film0 = torch.from_numpy(out["film"].copy())
    shard.dist.broadcast(film0, src=0)
    assert np.array_equal(film0.numpy(), out["film"]), f"rank {rank} holds another film"
    if rank == 0:
        np.savez(os.environ["LLR_TEST_OUT"], **out)
    shard.dist.destroy_process_group()


if __name__ == "__main__":
    main()
