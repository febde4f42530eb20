"""The plain reference: each family's problem worked out again from its
parameters, and the checks of a solve's answer against it. Plain NumPy,
``fractions`` and ``decimal``; nothing of the port or of JAX."""
