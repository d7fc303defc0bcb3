"""Plain references of what the configurations compute."""
