"""Model forward passes, generation and weight carry-over."""
