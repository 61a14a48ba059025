"""track_batch traffic: ``FoundationPose.track_batch`` of every object of a
frame in one call, along each object's own trajectory; the same generator
and check as ``track.py``."""

from __future__ import annotations

from benchmark.traffic import track


class Traffic(track.Traffic):
    batch_call = True
