"""Serving subsystem of the port: paged KV cache, continuous batching engine, load generator and CLI session."""
