"""The modified CBOW model."""
