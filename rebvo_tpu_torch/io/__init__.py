"""Host I/O: trajectories, logs and rendered test sequences."""
