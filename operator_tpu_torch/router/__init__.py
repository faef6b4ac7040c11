"""The port's copy of the router's value model (``router/value.py``)."""
