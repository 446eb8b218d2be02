"""Traffic kinds, by a workload's ``kind``: ``<kind>.py`` here sets the cell
up, warms it, runs the timed window and the traced stretch, and returns what
the reference compares. Its ``END_TO_END`` names the metrics it measures."""
