"""The process's peak resident memory over set-up and window, GB
(getrusage's ru_maxrss, read when the window closes)."""


def read(rec):
    return rec["peak_rss_gb"]
