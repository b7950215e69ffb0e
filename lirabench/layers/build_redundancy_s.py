"""build_redundancy_s: seconds of set-up in the index build's
``build.redundancy`` stage, the η-redundancy plan and its replica rows: the
program's ``lira_build_seconds_total{stage="redundancy"}``, counted to the
synchronize of the card that ends the stage."""
from lirabench import program


def read(r):
    return program.build_stage_s("redundancy")
