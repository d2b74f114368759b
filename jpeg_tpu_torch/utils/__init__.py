"""Quality/rate metrics and the stages' trace spans."""
