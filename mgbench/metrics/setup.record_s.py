"""setup.record_s: host seconds of the set-up's span "setup.record" (the
benchmark's own host clock around the call into the program)."""


def read(record: dict):
    return record["spans"].get("setup.record")
