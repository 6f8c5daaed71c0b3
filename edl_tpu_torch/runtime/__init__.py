"""Training runtime of the port: the elastic trainer and its optimizers, the
checkpointer, the virtual-worker loop and the stall watchdog."""
