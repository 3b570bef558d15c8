"""Token records and their readers (memmap and native), the tokenizers,
the COCO collator and span files, and the batch prefetch thread (host
side)."""
