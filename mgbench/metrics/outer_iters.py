"""outer_iters: mean refinement iterations a solve over the window, from
the iteration counts the solve driver returned."""


def read(record: dict):
    kind = record["config"]["solve"]["iterations"]
    if kind != "outer" or not record["iters"]:
        return None
    return sum(record["iters"]) / len(record["iters"])
