"""Test package: a regular package, so `tests.*` imports resolve here even
where another installed distribution ships a top-level `tests` package."""
