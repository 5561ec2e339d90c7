"""Stop-word and punctuation kill-sets of the offline preprocessor (port
of umpr_tpu/text/stoplists.py, the same sets).

They match the reference's data files exactly (embedding/stopwords.txt,
126 words, a standard English stop-word list, and
embedding/punctuations.txt, 28 characters): any drift changes the
train/valid/test CSVs (reference: data/data_process.py:34-47).

Note the quirks preserved here:
- the apostrophe is NOT in the punctuation set, so contractions survive
  until the tokenizer splits them ("don't" -> "don", "'", "t");
- '.' IS in the set but the preprocessor removes it from the kill-set at
  runtime so sentence boundaries survive (data_process.py:38).
"""

STOP_WORDS = frozenset(
    "i me my myself we our ours ourselves you your yours yourself yourselves "
    "he him his himself she her hers herself it its itself they them their "
    "theirs themselves what which who whom this that these those am is are "
    "was were be been being have has had having do does did doing a an the "
    "and but if or because as until while of at by for with about against "
    "between into through during before after above below to from up down in "
    "out on off over under again further then once here there when where why "
    "how all any both each few more most other some such no nor not only own "
    "same so than too very s t can will just don should now".split()
)

PUNCTUATIONS = frozenset(',./?<>;:"[]|\\+-=_()*&^%$#@!~`')
