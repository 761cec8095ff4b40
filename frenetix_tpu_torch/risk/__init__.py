"""Risk and harm assessment: collision probabilities, injury-probability
models and the per-candidate risk aggregation."""
