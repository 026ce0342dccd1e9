"""Run setup helpers: seeding and logging."""
