"""Configuration."""
