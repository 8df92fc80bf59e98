"""Per-step operators: forces, integration, broad phase, contact table."""
