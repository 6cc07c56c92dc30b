"""Host seconds of the engine's ``letterbox`` stage (``StageTimer``) over
the window, per photo completed: the host resize onto the canvas and the
upload."""

from portbench.core.readings import stage_s_per_unit


def read(run):
    return stage_s_per_unit(run, "letterbox")
