"""Host utilities: progress, logging, field tracing, filters."""
