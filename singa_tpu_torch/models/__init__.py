"""Model zoo (GPT-2 and the ResNet family so far)."""
