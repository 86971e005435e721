"""The yardstick of each model type, one file each, found by the model type."""
