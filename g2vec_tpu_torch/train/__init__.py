"""The full-batch CBOW trainer."""
