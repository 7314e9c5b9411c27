"""records_in_window: recordings of a program (span "program.record":
warm-up and capture) inside the traced window's calls; 0 where the
warm-up recorded every shape the window uses."""
from mgbench import program


def read(record: dict):
    calls = program.window_calls(record)
    if calls is None:
        return None
    return sum(1 for c in calls for r in c if r[0] == "program.record")
