"""Clip-by-clip tracking: the host ``OverTracker`` and the device tracker."""
from .over_tracker import ClipResults, OverTracker, ctt_similarity

__all__ = ["ClipResults", "OverTracker", "ctt_similarity"]
