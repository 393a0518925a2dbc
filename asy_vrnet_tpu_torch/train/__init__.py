"""Training: optimiser, schedules, EMA, train state and the train / eval steps."""
