"""Search core of the port: tree, UCT, games, scheduler, GSCPM, sequential UCT."""
