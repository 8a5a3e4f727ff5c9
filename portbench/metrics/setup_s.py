"""Set-up seconds: from the process's start to the window's (load, image,
prewarm or record, warm-up)."""


def read(rec):
    return rec["setup_s"]
