"""build_tier_s: seconds of set-up in the index build's ``build.tier`` stage,
the tier's store (a cast for f32; PQ's codebooks and codes for the quantized
tiers): the program's ``lira_build_seconds_total{stage="tier"}``, counted to
the synchronize of the card that ends the stage."""
from lirabench import program


def read(r):
    return program.build_stage_s("tier")
