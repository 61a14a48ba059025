"""CUDA graph captures the program made after the warm-up, a thousand calls
(the program's own count, ``profiling.RECORDER.captures``, read by the
traffic after the timed window and the traced slice, over the calls of
both): 0 where one program serves every set of names of a batch size the
warm-up met. Nothing where the program does not count its captures."""


def read(run):
    captures, calls = run.work.get("window_captures"), run.work.get("window_calls")
    if captures is None or not calls:
        return None
    return 1000.0 * captures / calls
