"""Experiments mode: the experiment registry, the metrics and the evaluators."""
