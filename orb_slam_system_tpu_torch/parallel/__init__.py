"""The multi-sequence mode (BASELINE.json config 5) on one card:
`multi_system.MultiSystem` runs S full Systems on one batched extraction,
`multiseq.make_multiseq_step` is the batched front-end step."""
