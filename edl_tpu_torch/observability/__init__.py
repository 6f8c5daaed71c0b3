"""The port's logging, counters and trace events: the part of
edl_tpu.observability that the trainer uses."""
