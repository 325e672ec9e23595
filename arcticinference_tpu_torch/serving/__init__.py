"""Host-side serving pieces of the port: grammar-guided decoding
(``structured.make_guided_decoder``; the DFA compilers ``regex_dfa`` and
``schema_regex``; the token sweeper ``guided_dfa``)."""
