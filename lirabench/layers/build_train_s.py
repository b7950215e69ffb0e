"""build_train_s: seconds of set-up in the index build's ``build.train`` stage,
the training subsample, its exact k-NN labels and the probing model's
training: the program's ``lira_build_seconds_total{stage="train"}``, counted
to the synchronize of the card that ends the stage."""
from lirabench import program


def read(r):
    return program.build_stage_s("train")
