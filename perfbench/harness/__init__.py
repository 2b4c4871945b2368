"""Code shared by every cell: traffic, weights, the served path's glue,
the window, the trace reader and the comparison that decides
``correct``.  Nothing here names a configuration or a cell."""
