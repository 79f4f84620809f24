"""Training of the port: the train state, the steps and epoch programs,
the trainer and checkpoint IO."""
