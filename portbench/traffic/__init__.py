"""Traffic runners (<kind>.py) and traffic mixes (<name>.json)."""
