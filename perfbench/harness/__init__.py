"""The harness: manifest, set-up and solve loop, answers, trace, roofline."""
