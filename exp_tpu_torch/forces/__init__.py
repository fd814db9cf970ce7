"""Force evaluators."""
