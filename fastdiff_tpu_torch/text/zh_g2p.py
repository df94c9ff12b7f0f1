"""Chinese grapheme-to-pinyin G2P, self-contained.

The port's copy of ``fastdiff_tpu/text/zh_g2p.py`` (the port imports
nothing of the JAX package).

Covers the role of the reference's g2pM-based processor
(reference: data_gen/tts/txt_processors/zh_g2pM.py): hanzi -> tone-numbered
pinyin syllables with word-context polyphone disambiguation. External
packages (g2pM / pypinyin, with full lexicons and a trained polyphone
model) are preferred when importable; this image has neither, so a
built-in layer provides:

- a word-level dictionary for common polyphone contexts (longest-match
  first: 银行 -> yin2 hang2 but 行走 -> xing2 zou3),
- a single-character lexicon for frequent hanzi + every character the
  normalizer (text/zh_norm.py) can emit, so normalized NSW text is always
  fully covered,
- tone-sandhi post-rules for 不 (bu4 -> bu2 before tone 4) and 一
  (yi1 -> yi2 before tone 4, yi4 before tones 1/2/3).

Unknown characters map to the ``UNK`` token (kept, so alignment lengths
stay consistent) — extend ``CHAR_PINYIN``/``WORD_PINYIN`` or install g2pM
for open-vocabulary coverage.
"""

from __future__ import annotations

import re
from typing import List

# -- word-level polyphone contexts (longest-match first) ---------------------
WORD_PINYIN = {
    "银行": "yin2 hang2", "行走": "xing2 zou3", "行为": "xing2 wei2",
    "自行车": "zi4 xing2 che1", "行业": "hang2 ye4",
    "重庆": "chong2 qing4", "重要": "zhong4 yao4", "重复": "chong2 fu4",
    "音乐": "yin1 yue4", "快乐": "kuai4 le4", "乐器": "yue4 qi4",
    "长城": "chang2 cheng2", "成长": "cheng2 zhang3", "长大": "zhang3 da4",
    "首都": "shou3 du1", "都是": "dou1 shi4",
    "了解": "liao3 jie3", "好了": "hao3 le5",
    "觉得": "jue2 de5", "睡觉": "shui4 jiao4",
    "还是": "hai2 shi4", "还有": "hai2 you3", "归还": "gui1 huan2",
    "地方": "di4 fang1", "慢慢地": "man4 man4 de5",
    "得到": "de2 dao4", "觉得很": "jue2 de5 hen3", "跑得": "pao3 de5",
    "便宜": "pian2 yi5", "方便": "fang1 bian4",
    "数学": "shu4 xue2", "数数": "shu3 shu4",
    "发现": "fa1 xian4", "头发": "tou2 fa5",
    "中国": "zhong1 guo2", "打中": "da3 zhong4",
    "干净": "gan1 jing4", "干活": "gan4 huo2",
    "教师": "jiao4 shi1", "教书": "jiao1 shu1",
}

# -- single-character lexicon -------------------------------------------------
# every char text/zh_norm.py can emit, then frequent hanzi
CHAR_PINYIN = {
    "零": "ling2", "一": "yi1", "二": "er4", "三": "san1", "四": "si4",
    "五": "wu3", "六": "liu4", "七": "qi1", "八": "ba1", "九": "jiu3",
    "十": "shi2", "百": "bai3", "千": "qian1", "万": "wan4", "亿": "yi4",
    "点": "dian3", "负": "fu4", "分": "fen1", "之": "zhi1", "到": "dao4",
    "年": "nian2", "月": "yue4", "日": "ri4", "号": "hao4", "整": "zheng3",
    "秒": "miao3", "元": "yuan2", "摄": "she4", "氏": "shi4", "度": "du4",
    "幺": "yao1", "〇": "ling2",
    # frequent characters
    "的": "de5", "是": "shi4", "不": "bu4", "我": "wo3", "你": "ni3",
    "他": "ta1", "她": "ta1", "它": "ta1", "们": "men5", "这": "zhe4",
    "那": "na4", "有": "you3", "在": "zai4", "人": "ren2", "了": "le5",
    "大": "da4", "小": "xiao3", "中": "zhong1", "上": "shang4", "下": "xia4",
    "个": "ge4", "国": "guo2", "说": "shuo1", "来": "lai2", "去": "qu4",
    "好": "hao3", "很": "hen3", "会": "hui4", "能": "neng2", "要": "yao4",
    "和": "he2", "与": "yu3", "就": "jiu4", "也": "ye3", "都": "dou1",
    "而": "er2", "但": "dan4", "被": "bei4", "把": "ba3", "让": "rang4",
    "给": "gei3", "从": "cong2", "向": "xiang4", "对": "dui4", "为": "wei4",
    "以": "yi3", "所": "suo3", "因": "yin1", "于": "yu2", "此": "ci3",
    "天": "tian1", "地": "di4", "山": "shan1", "水": "shui3", "火": "huo3",
    "风": "feng1", "雨": "yu3", "雪": "xue3", "云": "yun2", "电": "dian4",
    "车": "che1", "门": "men2", "家": "jia1", "学": "xue2", "生": "sheng1",
    "工": "gong1", "作": "zuo4", "时": "shi2", "候": "hou4", "间": "jian1",
    "前": "qian2", "后": "hou4", "左": "zuo3", "右": "you4", "东": "dong1",
    "西": "xi1", "南": "nan2", "北": "bei3", "京": "jing1", "市": "shi4",
    "省": "sheng3", "县": "xian4", "区": "qu1", "路": "lu4", "街": "jie1",
    "看": "kan4", "听": "ting1", "读": "du2", "写": "xie3", "画": "hua4",
    "唱": "chang4", "跳": "tiao4", "跑": "pao3", "走": "zou3", "飞": "fei1",
    "吃": "chi1", "喝": "he1", "睡": "shui4", "坐": "zuo4", "站": "zhan4",
    "手": "shou3", "脚": "jiao3", "头": "tou2", "眼": "yan3", "耳": "er3",
    "口": "kou3", "心": "xin1", "身": "shen1", "体": "ti3", "发": "fa1",
    "白": "bai2", "黑": "hei1", "红": "hong2", "黄": "huang2", "蓝": "lan2",
    "绿": "lv4", "色": "se4", "光": "guang1", "明": "ming2", "暗": "an4",
    "新": "xin1", "旧": "jiu4", "高": "gao1", "低": "di1", "长": "chang2",
    "短": "duan3", "多": "duo1", "少": "shao3", "快": "kuai4", "慢": "man4",
    "早": "zao3", "晚": "wan3", "今": "jin1", "昨": "zuo2", "春": "chun1",
    "夏": "xia4", "秋": "qiu1", "冬": "dong1", "花": "hua1", "草": "cao3",
    "树": "shu4", "林": "lin2", "鸟": "niao3", "鱼": "yu2", "马": "ma3",
    "牛": "niu2", "羊": "yang2", "狗": "gou3", "猫": "mao1", "爱": "ai4",
    "喜": "xi3", "欢": "huan1", "想": "xiang3", "知": "zhi1", "道": "dao4",
    "话": "hua4", "语": "yu3", "文": "wen2", "字": "zi4", "书": "shu1",
    "音": "yin1", "声": "sheng1", "气": "qi4", "物": "wu4", "事": "shi4",
    "情": "qing2", "理": "li3", "力": "li4", "用": "yong4", "做": "zuo4",
    "开": "kai1", "关": "guan1", "出": "chu1", "入": "ru4", "回": "hui2",
    "过": "guo4", "起": "qi3", "放": "fang4", "拿": "na2", "打": "da3",
    "没": "mei2", "再": "zai4", "又": "you4", "只": "zhi3", "最": "zui4",
    "更": "geng4", "太": "tai4", "真": "zhen1", "正": "zheng4", "同": "tong2",
    "样": "yang4", "别": "bie2", "各": "ge4", "每": "mei3", "些": "xie1",
    "怎": "zen3", "么": "me5", "什": "shen2", "谁": "shei2", "哪": "na3",
    "吗": "ma5", "呢": "ne5", "吧": "ba5", "啊": "a5", "呀": "ya5",
    "老": "lao3", "师": "shi1", "朋": "peng2", "友": "you3", "孩": "hai2",
    "子": "zi3", "女": "nv3", "男": "nan2", "父": "fu4", "母": "mu3",
    "哥": "ge1", "姐": "jie3", "弟": "di4", "妹": "mei4", "儿": "er2",
    "温": "wen1", "冷": "leng3", "热": "re4", "晴": "qing2", "阴": "yin1",
}

_HANZI_RE = re.compile(r"[〇一-鿿]")


def is_hanzi(ch: str) -> bool:
    return bool(_HANZI_RE.match(ch))


def _external_g2p(text: str):
    """Use g2pM or pypinyin when the image has them (the reference's path)."""
    try:
        from g2pM import G2pM
        if not hasattr(_external_g2p, "_g2pm"):
            _external_g2p._g2pm = G2pM()
        return _external_g2p._g2pm(text, tone=True, char_split=False)
    except ImportError:
        pass
    try:
        from pypinyin import Style, lazy_pinyin
        return lazy_pinyin(text, style=Style.TONE3, neutral_tone_with_five=True)
    except ImportError:
        return None


def apply_sandhi(sylls: List[str], chars: List[str]) -> List[str]:
    """Tone sandhi for 不 and 一 (context = following syllable's tone)."""
    out = list(sylls)
    for i, ch in enumerate(chars):
        if i + 1 >= len(out) or not out[i + 1] or not out[i + 1][-1].isdigit():
            continue
        next_tone = out[i + 1][-1]
        if ch == "不" and next_tone == "4":
            out[i] = "bu2"
        elif ch == "一" and out[i] == "yi1":
            out[i] = "yi2" if next_tone == "4" else "yi4"
    return out


def zh_segment(text: str) -> List[str]:
    """Word segmentation: jieba when importable, else greedy longest-match
    over the word lexicon with single-character fallback (the char-level
    segmentation standard for Chinese MFA runs). Non-hanzi characters are
    returned as their own tokens."""
    try:
        import jieba
        return [w for w in jieba.cut(text) if w.strip()]
    except ImportError:
        pass
    out, i = [], 0
    max_word = max((len(w) for w in WORD_PINYIN), default=1)
    while i < len(text):
        if not is_hanzi(text[i]):
            out.append(text[i])
            i += 1
            continue
        for w in range(min(max_word, len(text) - i), 1, -1):
            if text[i: i + w] in WORD_PINYIN:
                out.append(text[i: i + w])
                i += w
                break
        else:
            out.append(text[i])
            i += 1
    return out


def zh_g2p(text: str, unk: str = "UNK") -> List[str]:
    """hanzi string -> tone-numbered pinyin syllables (one per character;
    non-hanzi characters are dropped). Longest-match word dictionary first,
    then the char lexicon, then ``unk``."""
    ext = _external_g2p(text)
    if ext is not None:
        return [s for s, ch in zip(ext, text) if is_hanzi(ch)]

    chars = [ch for ch in text if is_hanzi(ch)]
    clean = "".join(chars)
    sylls: List[str] = [None] * len(clean)
    i = 0
    max_word = max((len(w) for w in WORD_PINYIN), default=1)
    while i < len(clean):
        for w in range(min(max_word, len(clean) - i), 1, -1):
            word = clean[i: i + w]
            if word in WORD_PINYIN:
                for k, s in enumerate(WORD_PINYIN[word].split()):
                    sylls[i + k] = s
                i += w
                break
        else:
            sylls[i] = CHAR_PINYIN.get(clean[i], unk)
            i += 1
    return apply_sandhi(sylls, chars)
