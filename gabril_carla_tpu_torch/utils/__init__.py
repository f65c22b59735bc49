"""Config surface, experiment logging and stage timers."""
