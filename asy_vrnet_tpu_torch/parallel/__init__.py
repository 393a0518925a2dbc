"""Data-parallel training over N ranks and the model-axis sharding rules (the
port's counterpart of `asy_vrnet_tpu/parallel/`): `mesh` (process groups,
the ("data", "model") mesh, the parallel train and eval steps),
`sharding_rules` (output-channel sharding of wide weights) and
`collectives` (the global reductions the model and the losses take inside
a parallel step)."""
