"""Input long-read bases of every job completed in the window over the
window's wall seconds, from the first job's start to the last job's end."""


def read(rec):
    return rec["bases"] / rec["window_s"]
