"""Unicode data of the ``tokenizers`` library's text front end.

Generated by ``PYTHONPATH=. python scripts/torch_text_tables.py`` from
the installed library (tokenizers 0.22.2); do not edit.  Each is
what the library takes from a Rust crate of its own Unicode version, so
Python's ``unicodedata`` cannot stand in for it:

- ``BERT_CONTROL``: what ``BertNormalizer``'s ``clean_text`` drops;
  ``BERT_MARK_NONSPACING``: the marks its accent stripping drops after
  NFD; ``BERT_CJK``: the ideographs ``handle_chinese_chars`` spaces;
- ``COMBINING_MARK``: what ``StripAccents`` drops;
- ``PUNCTUATION``: what ``BertPreTokenizer`` and ``Punctuation`` isolate;
- ``NORMALIZATION_CUTS``: where the library's normalization tables and
  ``unicodedata`` disagree (each a starter with no mapping to the
  library: a text is normalized on either side of one);
- ``LOWERCASE``: code point -> ``Lowercase``'s result, where it is not
  ``str.lower``'s;
- ``NUMERIC``: what ``Digits`` splits off; ``WORD`` and ``SPACE``:
  ``Whitespace``'s ``\\w`` and ``\\s`` (``WORD`` is also what an added
  token's ``single_word`` counts as a word character);
- ``GRAPHEMES``: ``Precompiled``'s grapheme cluster classes, the Indic
  conjunct ones (``Consonant``, ``Linker``, ``InCBExtend``) too.

A set is encoded as ``unicode_tables``' are.
"""

from __future__ import annotations


BERT_CONTROL = (
    "aicbbrC5BanaBKsfwaGaaBraEH4aB/2e0eBrebjBP8qGH5BP5aHzcbaEF5aBK/cdFGphYLUga4C5B/8aB//3cB//3"
)

BERT_MARK_NONSPACING = (
    "YaDpIteIjBmbabbbbbaCikBquqaDfgcfcbbdBda40C1kB0iBcdbibcbeBlcEh5Bxabaeheadgkb3aB0aediaub3bBzae"
    "bebccda4bdalbBzaeebbeaub3aB0acabdiaialb4aB3amaBsaB3cfcbdhblb3aB0acagafbub3aB5diaubDgahcbaC0a"
    "cgmhDcacfbblfCkb1ababaBxnbebbfkbBdjaDgdbfbbcbzbecqdnacbgapaV5c9sc3c3b4bCabbgiackjaBncE1aDwce"
    "bjagcG1bcaB0abgbabachgjcaBqnCcdBqabebafaBiimbBadcbbcByabbdabcB0hcbEycbmbgeagadbGgBvgdWqmeadl"
    "C/4cEnaDa5RkdDlb9OuaejBabCqbIqadaeazbE3a1rBuhzkBocBqacdcaBiaCdfcbcbmaiaBpaBtabccbfbbaBkbiaHo"
    "acaeaTZqaXbpqp+naHcaEveBUgcbbfdBiceaFfbBI0aBwoBycBrdcbCfcBeebhB4ambBuilcDcccabbFhadhvbB0adaB"
    "fgdeJ4fbaebbbHodgbbb1bCvhcabbDkabacfbaDfccdbeU+eeB1gBCydTIkbFGicrhcg4dEucB91BweBriaoaweboDRa"
    "gYGBjHp"
)

BERT_CJK = (
    "NAaGN5CaUP5WIaP5CBIaBJW5BaEI5IaFMpKKqQ5"
)

COMBINING_MARK = (
    "YaDpItgIhBmbabbbbbaCikBquqaDfgcfcbbdBda40C1kB0iBcdbibcbeBlcDynbBaBwcbrbgkb3cByabgcbccjakb3cB"
    "yabeebccda4bdalcByabhbcbcub3cByabgcbccibkb4aB1edcbdjaBidB0gbcbdhblb3cByabgbcbdhblb3cB0gbcbdj"
    "akb4bCgaefbabhsbB3acgmhDcacfbblfCkb1ababaebBrtbbfkbBdjaDetxdecbccgddnlbakdV5c9sc3c3b4bCa5jaB"
    "ncDxbBcaDwlelG1eBzjb2caBqoCbeBpqBgimc4mBynBqtEycbueaecdbGgBvfeWqBaC/4cEnaDa5RkfDjb9OudbjBabC"
    "qbIqadaeaxeCybBsr0rBuhzmBmdBpnBeaCdnmaibBncBsabccbfbbaBjefbHmhbbTZqaXbpqp+naHcaEveBUgcbbfdBi"
    "ceaFfbBIzcBvoBydBnkCfcBenB4amcBqnjcC5lgaFalvdByabgcbccjakbcgdeGarDjtHlgci1bCsqDkmDfoBIdhbhCs"
    "vbnTRzeB1gBA0BnqdTIkbFGgedfihcg4dEucB91BweBriaoaweboBKqgbqcgbbbeCFfgDngYF9vHp"
)

PUNCTUATION = (
    "Bbokg0f0dBcafadakbdadaV4aiaOsfBjbBtabacacaBmbubbbnacbCkdDgaBlnHjcBwo5aIfbkaL5aYdaC0akbFiobaB"
    "fdChaCkeebDpfFlaTeiExaTmbBmbCocChbE3cbcBfkJzbGybEagbfFmgE1dB1eB4bCahlaZ2xitbmbl4bobTzd3bBB3n"
    "Cpb5jMtvB5dBabX1dbbDqaEpBobsN4cejclqamaDcaC0a9AcbIncDdakaDtfL2dCwbBicbaBrbBpaDbmqbD2dD4bqbHz"
    "aUKsbGqjwBcbnbaeabbEvcbfbdkbdb0cba1ababgM0cU2aBqaM4aXhaGha5aIqiBgaDqgCcgCzdBFkgDnbbdD4dBqbCp"
    "edanabcCyfDlaQ2aH0wDjcHycDJreRPzbEfaCbeiaUK0aHPhe"
)

NORMALIZATION_CUTS = (
    "B/3aE0hBkjJkaR3aH4bL3aCC0a9jpZheFIea9HscBxaZ2aXAxebBjbiBLjdMdbCqcCgkBrdHkaWkaJca+0bHvaeacaeb"
    "eaE2aCtasaCraViabbCraNjbUFnb8B4B3BbaFagLxaB3dP2dDD2aCUdj"
)

NUMERIC = (
    "BqjDybfaccBNbjEgjGgjM2jDwjefDmjDwjDwjcfDomDtjigDhjDighsDnjDajDwjCgtImjCgjWpt7rcHpjgjwjJmjEak"
    "FfjgjFwjCwjEgjgjBAwadfgjGgBsceWwB1CovTw3BLjaYjaziocKxdEkj4hboBajBho87ajF2jKafE0jBgjGgjwjCwjM"
    "wjUYwjPnBmmByrbKv0Bed3aiaEgeGkj9ohzgBhiClewfFabcpcBnCaiBub4cCleDihyhBjgKkfBqjgjIw4E4jBkdDqgE"
    "g3EajB2jEqjhtH1jKwjDwjLwjDgjgtCmlNesC3jUwjCw2HdjCgjBwjLgjDguBBlDoPGbjCJgjCwjEgjbgQojIgwK3cXH"
    "zjBOgtmtDmyBCvBrCKajNgjPwjHxjWmiEajYxB0bcbdCmBmbo+cmCXdj"
)

WORD = (
    "BqjhzeabzBpakaeafwb4bOjeloehabarDubbcdbagabcbabtbCsbEkbFmbBfcagBiiBmbabbbbbai0ed3kfCjeDfbhcj"
    "bscaqB0cDeoBveacacBns1ekfxbfiCkbEacjbsbhcbcvbgbaddcicbcdiaebbeclkabaccbfebcvbgbbbbbbcabeebcc"
    "dahdbahplcbibcbvbgbbbecjbcbccapdcjjgbcbhcbcvbgbbbecicbcchcebbecjbaqbbfdcbddbbabbdbdcdleedcbd"
    "cagaojqmbcbwbpcibcbdhbbccacdcjqdbhbcbwbjbecibcbdhbgbbdcjbcmmbcbBsbcbefdhecjkfbcbrdxbibacgdae"
    "fbabhgjcbnBzfobjBhbbabebxbabwcebabgbjcdBaaxbgjlababaejbBdetbrbBdjaBzCjgCncBfbafacBkbKmbdcgba"
    "bdcBibdcBabdcgbabdcobBybdcCcccBapqCvcfdTlcqbzfCkdkhvjvltmmbcbbmCtdaebcjBbcbkgCyhBkfCfk4blelk"
    "BhcelBlezgjBg1eB4b2ckgjnai4BrCmdjrimDtmBxijdBqckfBkccqcbBgfQvcfcBfcfchbababab4cBubgbadcbgddc"
    "femfcbgpbBrbta2anaqmBtBaraeacjbadegabababdbkcdfeearBiZnBtBYwHegimBfbafacBxhapxjgbgbgbgbgbgbg"
    "bgb5BpaOvczobeceeCvcbccbCzbdfBkbC3r5BqpQaGN5CaVUmCdBncImd1uBsbjbDsBficDgcCccbbabhvBveatBtmCf"
    "kjgxdabBqcBdm2dCaokg4bBwjncjgwdCiyccpcekfcfcfjgbgbBkbngD0bbcjgK9dmweBqIIeLncDjBggmeflbmbebab"
    "bbbbDlBbLksB5cBvBilepqpdbycBaebEgtjhzeabzlCydfcfcfccBdlbzbsbbbocnBcD0CfBuEiaEc2dBqpa55n3fBkf"
    "3cBdehbeBkE3cjgBdeBdeBhiBtmkbobgbbbkbobgbbdBtmJwjvkhyfbBjbiCffcabBlbbdacwkwj4CbsbbkvkzCgBxgb"
    "Cadbbfhbcb2cceaBa2d2Bdhb3zBvkvksnrDoCiBxBsnBsnBhijgBfdebwH0BjbbdbqcBxBakaiBa5vBku1wjCg5pjB1h"
    "anyhjgBubjediBdcajCeedbmbaBdrbBegdB4gbabdbobjhB0fjgdbhcbcvbgbbbebjcbcccagafgcgdeljbacabBfbjb"
    "acabdbhnb3Ckfjed4CfbaijFgBvcixfBcCadaljBgByhjgt20coejggFzB0DfCjvhcachbbb3bbcimjCghcBnchbb1B4"
    "iaiCjdasCiGhBapjgibBmbipjy3cvbnCjgbbbBldabbbiijgfbbbBebbbfhjJwwjqbBidenkCvaCp8zDgDorGdCSmDap"
    "BBpqvkD80fSgGVzBzBWgRyh4bjgCobjg3celBwjdmjjufsNqBmdjGgB5EaCkeByhqCabbblboF/xiBGvBjjIXhdbgbbb"
    "Jcpa3ccaodiMlCIeDkfmdihjdbECrjQgBncwQ4edfihcg4dEucN1CubCgbbcacbcdblbabgbCabdchbgb1bdbebadgbK"
    "tcybyb4byb4byb4byb4bybhcBrQaBweBriaoaweboBCq4gfGvgbqcgbbbefB3BbaDqBmdncjeaKb4rBzOwBjGwBkPfgb"
    "dbbbobGelgBjClejBFgdb0bbbacabjbdbabagaeabababcbbbacabababababbbacdbgbdbdbabjbqfcbebqTuzgzgzC"
    "TgjBAgBJW5BaEBzgG3cFUboHJqpTnCNcQ3BPcE6kfEC5VXKqHp"
)

SPACE = (
    "jesaDea0aFO5aCL5k3bfaBpaD9aa"
)

LOWERCASE = {
    0x1C89: '\u1c8a',
    0xA7CB: 'ɤ',
    0xA7CC: '\ua7cd',
    0xA7CE: '\ua7cf',
    0xA7D2: 'ꟓ',
    0xA7D4: 'ꟕ',
    0xA7DA: '\ua7db',
    0xA7DC: 'ƛ',
    0x10D50: '\U00010d70',
    0x10D51: '\U00010d71',
    0x10D52: '\U00010d72',
    0x10D53: '\U00010d73',
    0x10D54: '\U00010d74',
    0x10D55: '\U00010d75',
    0x10D56: '\U00010d76',
    0x10D57: '\U00010d77',
    0x10D58: '\U00010d78',
    0x10D59: '\U00010d79',
    0x10D5A: '\U00010d7a',
    0x10D5B: '\U00010d7b',
    0x10D5C: '\U00010d7c',
    0x10D5D: '\U00010d7d',
    0x10D5E: '\U00010d7e',
    0x10D5F: '\U00010d7f',
    0x10D60: '\U00010d80',
    0x10D61: '\U00010d81',
    0x10D62: '\U00010d82',
    0x10D63: '\U00010d83',
    0x10D64: '\U00010d84',
    0x10D65: '\U00010d85',
    0x16EA0: '\U00016ebb',
    0x16EA1: '\U00016ebc',
    0x16EA2: '\U00016ebd',
    0x16EA3: '\U00016ebe',
    0x16EA4: '\U00016ebf',
    0x16EA5: '\U00016ec0',
    0x16EA6: '\U00016ec1',
    0x16EA7: '\U00016ec2',
    0x16EA8: '\U00016ec3',
    0x16EA9: '\U00016ec4',
    0x16EAA: '\U00016ec5',
    0x16EAB: '\U00016ec6',
    0x16EAC: '\U00016ec7',
    0x16EAD: '\U00016ec8',
    0x16EAE: '\U00016ec9',
    0x16EAF: '\U00016eca',
    0x16EB0: '\U00016ecb',
    0x16EB1: '\U00016ecc',
    0x16EB2: '\U00016ecd',
    0x16EB3: '\U00016ece',
    0x16EB4: '\U00016ecf',
    0x16EB5: '\U00016ed0',
    0x16EB6: '\U00016ed1',
    0x16EB7: '\U00016ed2',
    0x16EB8: '\U00016ed3',
}

GRAPHEMES = {
    'CR': 'na',
    'LF': 'ka',
    'ZWJ': 'IAna',
    'Control': 'ajbbbrC5BanaBLoaEPraB/2acbygBrpBXUpaHqlNBupBCDadFGphYLUf5DaD5HqDQp',
    'Prepend': 'BQafGxaBraMabCqaBDlaCA7oapaHubQnaBLnabaHyaCjfV2aN1a',
    'Extend': 'YaDpItgIhBmbabbbbbaCikBquqaDfgcfcbbdBda40C1kB0ijaydbibcbeBlcB1iBkxb5Bxabaeheadgkb3aB0abacdiajakb0acbBzaebebccda4bdalbBzaeebbeaubwfbaB0abbbdiahckb4aB1abamajaBiadaBxabcfcbdhblb3aB0acbbadcbdhblb2bBzbbacdiajakb3aCiaeaccbaiaCracgmhDcacilgCjb1ababaBxnbebbfkbBdjaDgdbfbbcbzbecqdnacbgapaV5c9sd2c3b4bCabbgiackjaBncbaDvbBcaDwcebjagcG1bcaB0abgbabachgjcaBq4BrdBqjecBgimbBadcfByabbdabeByhcbEycbmbgeagadbGgB5QmaGdBaC/4cEnaDa5RkfDjb9OudbjBabCqbIqadaeazbfaExb0rnaBghzkbaBmcBqacdcbcaBeaCdfcbcbmaiaBpaBtabccbfbbaBkbiaHoacaeaTZqaXbpqpLobS3aHcaEveBUgcbbfdBiceaFfbR3dCbeJ3bCpdCgkBrdD1aBwoBjacbkcBrdcbhaB3cBeebhB4ambBuibaidcaC5ccdgacaE3adhvbBzbbabamajaogdeCdacfbacabcecbaobCvhccbaxaCracfbacabbbbHlacdgbbb1bCvhcabbDkabachDfabacdbeIdibbHvakdeaEqdcbeaBajBifcdiajfccBombbMwgbfbaCsvcgbbbbD0fdabbbgbaCibdabaK1blbBuefcxaFHfagoLGildcCOaeB1gBAyaB5dCralbTFlbETbBncwQ4edfihcg4dEucB91BweBriaoaweboBKqgbqcgbbbeDeaFagLxaB3dP2dH4bXagDngCVqeYDBaC5EaHp',
    'L': 'EIaC5BGAa2',
    'V': 'ELaChBRQiwBFM2add',
    'T': 'ENiCxBROlBq',
    'LV': 'BLAaa1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a1a',
    'LVT': 'BLAb0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0b0',
    'RI': 'D8Pgz',
    'ExtPict': 'FjaeaH8namaGyawaC0fpbLpbmaC5aCgazkecGhaHhbkajaB0dbfblbDrkDvckbabagadagakbpacaeabaecbaleBncjaoaoaLubOpctbBtaeaBG0amaSzabaDPLgH5nc5aB2fmboacjsBy1okauacibdjNrfJ3iIjBqD5DulCvBkmdByhkfBih4CrmBobjbNyIa/3',
    'Consonant': 'CIvBe4hyhvtbgbaddBcbbaqbFdtbgbbbeB5a1tbgbbbeBcbbaraFdtbp4cF0Bf',
    'Linker': 'CKnaD5aH5aD5aH5aH5a',
    'SpacingMark': 'CIdaBxaccidbbBsbB1bgbcbBwaB0cCcaB0ciabbBvbB2agbcbDsabbdcbcBucB3dB3bB0acabbBoaobB1bfcbcBvbCmbggtbB5aD5aEkbB5aFrajbzbBmaBZrahhbbK0dccebbfHabB0abavfEraBzdCaa4aebB5accbaBvhibFlavaBCZlbcaCybBspEoaBqaBqbebcbDpbcbyaE3acbfaHnbbbbbbaZAtabaD5aBncebDtaybB1aBqcjaoaC3cdbFmc5bB1abdcbcbvbCvbpabbDhcibdaDlbgabbbacaHobgdcaDrcibbaDnabbDoahaIfcjaHyebbhabaEocideaCua3bB4aMxaoaDkahacaGveebbaK4bmaBqbibQPkcDReBw',
    'InCBExtend': 'YaDpItgIhBmbabbbbbaCikBquqaDfgcfcbbdBda40C1kB0ijaydbibcbeBlcB1iBkxb5Bxabaehigkb3aB0abacdsakb0acbBzaebebccda4bdalbBzaeebbzbwfbaB0abbbdqckb4aB1abamajaBiadaBxabcfcbciblb3aB0acbbadcbdhblb2bBzbbacdsakb3aCiaeaccbaiaCracgmhDcacilgCjb1ababaBxnbebbfkbBdjaDgdbfbbcbzbecqdnacbgapaV5c9sd2c3b4bCabbgiackjaBncbaDvbBcaDwcebjagcG1bcaB0abgbabachgjcaBq4BrdBqjecBgimbBadcfByabbdabeByhcbEycbmbgeagadbGgB5QnaGcBaC/4cEnaDa5RkfDjb9OudbjBabCqbIqadaeazbfaExb0rnaBghzkbaBmcBqacdcbcaBeaCdfcbcbmaiaBpaBtabccbfbbaBkbiaHoacaeaTZqaXbpqpLobS3aHcaEveBUgcbbfdBiceaFfbR3dCbeJ3bCpdCgkBrdD1aBwoBjacbkcBrdcbhaB3cBeebhB4ambBuibaidcaC5ccdgacaE3adhvbBzbbabamajaogdeCdacfbacabcecbaobCvhccbaxaCracfbacabbbbHlacdgbbb1bCvhcabbDkabachDfabacdbeIdibbHvakdeaEqdcbeaBajBifcdiajfccBombbMwgbfbaCsvcgbbbbD0fdabbbgbaCibdabaK1blbBuefcxaFHfagoLGildcCOaeB1gBAyaB5dCralbTFlbETbBncwQ4edfihcg4dEucB91BweBriaoaweboBKqgbqcgbbbeDeaFagLxaB3dP2dH4bXagDngCVqeYDBaC5EaHp',
}
