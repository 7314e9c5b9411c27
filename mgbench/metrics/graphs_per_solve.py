"""graphs_per_solve: CUDA graphs replayed per solve call, over the traced
window's calls: one a recorded program's replay (span "program.replay"),
one more after each host step inside it ("program.host_step")."""
from mgbench import program


def read(record: dict):
    return program.per_call(record, {"program.replay", "program.host_step"})
