"""Host-side utilities of the port: config and preemption handling."""
