"""The port's serving path: continuous scheduler, engine, HTTP front."""
