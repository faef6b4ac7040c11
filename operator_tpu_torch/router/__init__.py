"""The port's copies of the router's value model (``router/value.py``)
and circuit breakers (``router/health.py``)."""
