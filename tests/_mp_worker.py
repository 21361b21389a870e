"""Multi-process worker: one JAX controller of an N-process CPU cluster.

Launched by tests/test_multiprocess.py. Each subprocess hosts
``local_devices`` virtual CPU devices; ``jax.distributed.initialize`` over
gloo wires them into one global cluster -- the closest an unnetworked
single host gets to a multi-host pod. Two phases:

- ``fit_save``: run the production sharded pallas train step over a
  process-spanning (tile=2, splat=2) mesh (cross-process psum/all_gather/
  ppermute), check it against the single-device fused step computed
  independently on every process (deterministic init), and save the
  process-spanning sharded state through the orbax checkpointer.
- ``restore_check``: in a cluster with a DIFFERENT process count (same
  global device count), restore that checkpoint directly onto the new
  mesh, verify it matches the single-device trajectory, and take one more
  sharded step from the restored state (elastic resume across a
  process-count change -- the reference has no checkpointing at all;
  net-new per SURVEY.md section 5).

argv: port pid nproc local_devices ckdir combine phase
Prints MP_WORKER_OK on success; any assertion kills the exit code.
"""

import os
import sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
local_devices, ckdir = int(sys.argv[4]), sys.argv[5]
combine = sys.argv[6]
phase = sys.argv[7]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={local_devices}")
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")

import jax

jax.config.update("jax_platforms", "cpu")

from gs2d_tpu.parallel.multihost import initialize_cluster

initialize_cluster(coordinator_address=f"127.0.0.1:{port}",
                   num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == nproc * local_devices

import jax.numpy as jnp
import numpy as np

from gs2d_tpu.config import SplatConfig
from gs2d_tpu.io.checkpoint import Checkpointer
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.ops import render_tiles as rp
from gs2d_tpu.parallel.mesh import make_mesh
from gs2d_tpu.parallel.multihost import fetch_replicated, put_global
from gs2d_tpu.parallel.sharded import (init_batched_state,
                                       make_sharded_train_step,
                                       pad_ref_batch)
from gs2d_tpu.train.loop import init_train_state, make_train_step_fused

H, W = 32, 48
cfg = SplatConfig(width=W, height=H, n_splats=32, tile_h=8,
                  min_throughput=0.0, max_splats_per_tile=32)
# (tile=2, splat=2) over 4 global devices. With 4 processes x 1 device,
# BOTH mesh axes cross process boundaries on every edge; with 2 x 2 the
# tile axis crosses processes and splat is intra-process.
mesh = make_mesh(tile=2, splat=2)
step, sh = make_sharded_train_step(cfg, mesh, renderer="tiles",
                                   overlap_chunks=2, combine=combine)

ref = synthetic_target(H, W, seed=0)
refs = pad_ref_batch(jnp.asarray(ref)[None], cfg)
refs_g = put_global(np.asarray(refs), sh["ref"])

# Independent single-device reference on each process (min_throughput=0
# keeps the splat-sharded semantics identical to sequential).
sstep = make_train_step_fused(cfg)
s1 = init_train_state(cfg)
refc = rp.pad_ref_chw(jnp.asarray(ref), cfg)
out1, aux1 = sstep(s1, refc)

ck = Checkpointer(ckdir)

if phase == "fit_save":
    state = put_global(init_batched_state(cfg, 1), sh["state"])
    new_state, aux = step(state, refs_g)
    mse = float(fetch_replicated(aux.mse)[0])
    assert bool(fetch_replicated(aux.all_finite).all())
    assert np.isclose(mse, float(aux1.mse), rtol=1e-5), (
        mse, float(aux1.mse))
    new_pos = fetch_replicated(new_state.params.pos)[0]
    np.testing.assert_allclose(new_pos, np.asarray(out1.params.pos),
                               rtol=1e-4, atol=2e-3)
    # Orbax writes each process's shards; every process participates.
    ck.save(1, new_state, cfg)
    restored = ck.restore(1, new_state)
    np.testing.assert_array_equal(fetch_replicated(restored.params.pos),
                                  fetch_replicated(new_state.params.pos))
else:
    assert phase == "restore_check", phase
    # Restore the checkpoint written by a DIFFERENT process count onto
    # this cluster's mesh: orbax reassembles from the stored global shape,
    # landing shards directly on the new process-spanning sharding.
    template = put_global(init_batched_state(cfg, 1), sh["state"])
    restored = ck.restore(1, template)
    rest_pos = fetch_replicated(restored.params.pos)[0]
    np.testing.assert_allclose(rest_pos, np.asarray(out1.params.pos),
                               rtol=1e-4, atol=2e-3)
    assert int(fetch_replicated(restored.opt.step)[0]) == 1
    # One more sharded step from the restored state (elastic resume).
    next_state, aux = step(restored, refs_g)
    mse = float(fetch_replicated(aux.mse)[0])
    assert bool(fetch_replicated(aux.all_finite).all())
    out2, aux2 = sstep(out1, refc)
    assert np.isclose(mse, float(aux2.mse), rtol=1e-4), (
        mse, float(aux2.mse))

print(f"MP_WORKER_OK p{pid} combine={combine} phase={phase} "
      f"mse={mse:.4f}", flush=True)
