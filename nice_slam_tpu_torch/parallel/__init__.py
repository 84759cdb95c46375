"""Parallel backends of the port: groups of ranks (`mesh`), the
multi-process bring-up and keyframe-sharded mapping (`distributed`), the
ray-sharded steps and lattice query (`sharded`), and grid-block tensor
parallelism (`blocks`).  Ports of `nice_slam_tpu/parallel/`."""
