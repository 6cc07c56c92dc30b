"""Host seconds of the engine's ``recognize`` stage (``StageTimer``, through
``engine.timings()``) over the window, per photo completed. Host wall
clock: the stage ends in a download and holds the device work queued
before it."""

from portbench.core.readings import stage_s_per_unit


def read(run):
    return stage_s_per_unit(run, "recognize")
