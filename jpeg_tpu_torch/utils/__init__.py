"""Quality/rate metrics and stage timing."""
