"""The deterministic training-data pipeline."""
