"""Keyframe backend (the part the online tracker uses)."""
