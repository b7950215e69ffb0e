"""build_kmeans_s: seconds of set-up in the index build's ``build.kmeans``
stage, k-means over the base (``kmeans_fit``, 20 Lloyd iterations): the
program's ``lira_build_seconds_total{stage="kmeans"}``, counted to the
synchronize of the card that ends the stage."""
from lirabench import program


def read(r):
    return program.build_stage_s("kmeans")
