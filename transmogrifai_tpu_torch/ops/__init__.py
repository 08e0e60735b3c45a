"""Feature-engineering stages: the vectorizers ``transmogrify`` wires, the
combiner and the SanityChecker (the port of ``transmogrifai_tpu/ops/``)."""
