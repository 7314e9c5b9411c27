"""krylov_iters: mean Krylov iterations ((block) CG in the cells) a solve
call over the window, from the iteration counts the Krylov driver
returned."""


def read(record: dict):
    kind = record["config"]["solve"]["iterations"]
    if kind != "krylov" or not record["iters"]:
        return None
    return sum(record["iters"]) / len(record["iters"])
