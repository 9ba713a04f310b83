"""The multi-sequence mode (BASELINE.json config 5) and the sharded solvers:
`multi_system.MultiSystem` runs S full Systems on one batched extraction,
`multiseq.make_multiseq_step` is the batched front-end step (on one card,
or over a dp x sp grid of torch.distributed ranks), `ba_dist` and
`pose_graph_dist` split the global BA's and the essential graph's edges
over ranks, and `launch.spawn_ranks` starts ranks on one host."""
