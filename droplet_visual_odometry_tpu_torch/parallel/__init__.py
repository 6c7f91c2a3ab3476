"""Multi-device parallelism on torch.distributed — port of
droplet_visual_odometry_tpu/parallel/.

The process model. The reference is single-controller: one process
addresses every device, and shard_map/psum reduce over a jax Mesh. The port
runs one process (rank) per device, as NCCL wants:

  * `sharding.Mesh` is a small frozen record, not a device array: the
    process group (None when torch.distributed is not initialised), its
    `size`, this process's `rank` in it (-1 outside it), this rank's
    `device` and the `axis_name`. JAX's `mesh.devices.size` is `mesh.size`.
  * A psum is `dist.all_reduce` on that group. It is a no-op only without a
    group: a world of one rank over NCCL still runs the collective.
  * Every rank runs the whole call (SPMD). Inputs are full host copies on
    every rank; each rank takes its block of the sharded axis
    (`sharding.local_shard`, the counterpart of the reference's
    global_array), and replicated results are reduced or gathered so every
    rank holds them whole.
  * `launch.initialize` brings the group up: NCCL for "cuda" (device
    cuda:{LOCAL_RANK}), gloo for "cpu"; `backend="gloo"` with CUDA tensors
    is how two ranks share one card. A multi-GPU host shards only when run
    with one process per card, e.g. `torchrun --nproc-per-node N`.

Import-light by design: importing these modules initialises no process
group and touches no device. Import submodules explicitly:

    from droplet_visual_odometry_tpu_torch.parallel import launch
    from droplet_visual_odometry_tpu_torch.parallel import sharding
"""
