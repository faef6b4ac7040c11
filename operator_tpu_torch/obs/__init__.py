"""The port's copy of the step clock's records (``obs/steptrace.py``)."""
