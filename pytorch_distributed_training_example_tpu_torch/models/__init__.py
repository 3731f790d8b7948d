"""Models of the port: the Llama family and the model registry."""
