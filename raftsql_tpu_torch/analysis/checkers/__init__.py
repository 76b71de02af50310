"""raftlint passes.  Importing a module registers its checkers."""
