"""build_store_s: seconds of set-up in the index build's ``build.store`` stage,
the padded partition plane (``build_store``): the program's
``lira_build_seconds_total{stage="store"}``, counted to the synchronize of
the card that ends the stage."""
from lirabench import program


def read(r):
    return program.build_stage_s("store")
