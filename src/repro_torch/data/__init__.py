from .pipeline import PrefetchLoader, TokenDataset, synthesize_corpus
