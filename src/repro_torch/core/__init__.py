"""Neuron IR, the event-driven stepper, the plan compiler and the
application models (the port of `repro.core`)."""
