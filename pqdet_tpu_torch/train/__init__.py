"""Training: the learning-rate schedules and the train step."""
