"""Configuration and the native-kernel build bridge."""
