"""Scene-flow training: the train step, optimizer, loop and harness."""
