"""The harness: the cells' data files, the fields, the timed runs, the
traces and the metric arithmetic."""
