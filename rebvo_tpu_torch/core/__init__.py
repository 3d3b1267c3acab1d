"""Core math: SO(3), camera model, statistics, numeric helpers."""
