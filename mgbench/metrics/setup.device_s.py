"""setup.device_s: host seconds of the program's span "setup.device" over
the run: the device hierarchy (build_device_hierarchy: level operators,
smoothers and transfers moved to the card, and the coarsest solver's
set-up, span setup.coarsest, inside it). The program sums them itself
(mgtpu_torch.spans.SECONDS)."""
from mgbench import program


def read(record: dict):
    return program.seconds(record, "setup.device")
