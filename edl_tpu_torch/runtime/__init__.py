"""Training runtime of the port: the elastic trainer and its optimizers."""
