"""Quaternion and component-form vector math."""
