"""Training state and optimizer (port of ``repro.train``)."""
