"""The port's copies of the shipped examples: ``train_ft`` (word2vec on
the shipped corpus, run standalone or as a pod's entry under the
launcher)."""
