"""Model zoo (GPT-2 so far)."""
