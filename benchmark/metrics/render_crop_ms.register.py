"""Device ms a Register of its graph's ``render_crop`` stages (render and
crops before the refiner and before the scorer, summed), between the
timing events the program records inside its graph."""

from benchmark import program_trace


def read(run):
    return program_trace.stage_ms(run, "render_crop")
