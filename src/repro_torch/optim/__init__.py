"""The optimizer (AdamW with global-norm clipping) and its schedules."""
