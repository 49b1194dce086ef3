"""Tools of the port: the HBM read probes and their harness, ``fsck``,
the SIGKILL crash drill and the observability report (``obs_report``)."""
