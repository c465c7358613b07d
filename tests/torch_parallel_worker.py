"""One rank of the port's parallel helpers over ``torch.distributed`` with
the gloo backend, on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD PORT IN.npz OUT.npz

Rendezvous at tcp://localhost:PORT.  From IN.npz (written by
tests/test_torch_parallel.py): the old and new keyline maps and both fields
of a frame pair, for ``parallel.keyline_shard.make_minimize_vel_sharded``
on the attribute-field and the id-field routes (the old map sharded over
the ranks); the frames, IMU windows and intervals of a batch of sequences,
for ``parallel.batch.sharded_step_fn`` (this rank's lanes).  Writes to
OUT.npz: the sharded solves (velocity, score, the forward ids gathered from
every rank), ``make_pod_mesh``'s shape and ``local_batch_slice``, and this
rank's lanes after the batched steps.  Imports no JAX.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def unpack(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    src, dst = sys.argv[4], sys.argv[5]
    import torch
    import torch.distributed as dist

    from rebvio_tpu_torch import interop, types as T
    from rebvio_tpu_torch.configs import (CameraConfig, CoreConfig, EdgeDetectorConfig,
                                          ImuConfig, PipelineConfig)
    from rebvio_tpu_torch.parallel import batch, keyline_shard, multihost

    torch.set_num_threads(1)
    multihost.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    out = {}
    try:
        z = dict(np.load(src))
        cfg = json.loads(str(z["config"]))
        # --- keyline-sharded tracking, both routes
        old = interop.edge_map_from_numpy(unpack(z, "old."), device="cpu")
        new = interop.edge_map_from_numpy(unpack(z, "new."), device="cpu")
        cam = CameraConfig(**cfg["camera"])
        core = CoreConfig(**cfg["core"])
        old_sh = keyline_shard.shard_edge_map(old)
        new_rep = keyline_shard.shard_edge_map(new, shard_keylines=False)
        for route, field, fs, use_att in (("att", z["att"], cfg["fs"], True),
                                          ("id", z["ids"], 1, False)):
            fn = keyline_shard.make_minimize_vel_sharded(None, core, cam, field_scale=fs,
                                                         use_att=use_att)
            vel, Rvel, old_out, score = fn(old_sh, new_rep, torch.as_tensor(field))
            parts = [torch.empty_like(old_out.match_id_forward) for _ in range(world)]
            dist.all_gather(parts, old_out.match_id_forward)
            out.update({f"{route}.vel": vel.numpy(), f"{route}.Rvel": Rvel.numpy(),
                        f"{route}.score": score.numpy(), f"{route}.mif": torch.cat(parts).numpy()})
        # --- the pod mesh and the rank's batch slice
        mesh = multihost.make_pod_mesh(inner_axis="kl", device="cpu")
        out["mesh_shape"] = np.asarray(mesh.mesh.shape)
        out["mesh_names"] = np.asarray(mesh.mesh_dim_names)
        out["slice8"] = np.asarray(multihost.local_batch_slice(8, mesh))
        # --- the seq-sharded batched step: this rank's lanes
        pc = PipelineConfig(camera=CameraConfig(**cfg["tiny_camera"]),
                            detector=EdgeDetectorConfig(**cfg["tiny_detector"]),
                            core=CoreConfig(**cfg["tiny_core"]), imu=ImuConfig(sample_max=8),
                            use_imu=True)
        seq_mesh = batch.make_seq_mesh(device="cpu")
        fn, local = batch.sharded_step_fn(seq_mesh, pc)
        states = local(batch.init_batched_state(pc, int(z["frames"].shape[1]), device="cpu"))
        for i in range(z["frames"].shape[0]):
            win = interop.imu_frame_from_numpy({k: v[i] for k, v in unpack(z, "imu.").items()},
                                               device="cpu")
            states, odo = fn(states, local(torch.as_tensor(z["frames"][i])), local(win),
                             local(torch.as_tensor(z["dts"][i])))
            out[f"odo{i}"] = np.concatenate([odo.orientation.numpy(), odo.position.numpy(),
                                             odo.num_matches.numpy()[:, None]], axis=1)
        for j, x in enumerate(T.tree_leaves(states)):
            out[f"state{j}"] = x.numpy()
        np.savez(dst, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
