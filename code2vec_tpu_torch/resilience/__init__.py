"""Recovery machinery of the port (the retry policy of checkpoint IO)."""
