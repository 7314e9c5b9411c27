"""The program's side of each operator kind, one file a kind
(operators/<kind>.py, found by the configuration's `operator`):
`setup(cfg, inputs, device, spans)` assembles the operator with the
program's own `models` and sets the program up on the device, and
`levels(state, dtype=None)` hands the set-up's level operators to the
reference's `level_errors` (reference/<kind>.py)."""
