"""Host seconds of the set-up's index build: graph/build.py and
graph/colors.py (pass 1), pipeline.build_pass2_index (pass 2)."""


def read(rec):
    return rec["index_build_s"]
